"""Subprocess worker for tests/test_torch_mesh.py: the port's mesh code on
several CPU ranks (gloo) or on a fake process group.  A process group is
global to its process, so each job runs in processes of its own.

    python tests/_torch_mesh_worker.py JOB N_RANKS OUT_DIR [ARGS...]

spawns N_RANKS ranks on a localhost gloo group (or, for the fake jobs,
runs rank 0 of a fake group in this process); rank 0 writes
OUT_DIR/result.json (and .npz where the test compares arrays) and the
worker prints "MESH-WORKER-OK" as its last line.

Jobs:
  hop      the DiLoCo wire hop over the "pod" group on (2, 2, 2):
           `_wire_shard_hop` == `_wire_sim_hop` bitwise for int8 and
           top-k, pod 1 masked in round 1, error feedback carried into
           round 2; the inputs and outputs saved for the reference.
  step     make_sharded_train_step, make_sharded_fused_steps and
           make_diloco_round(mesh=) against their unmeshed forms, f32, on
           (1, 1, 1) (ARGS: "bitwise") or (2, 2, 2).
  family   ARGS: an arch.  Two sharded train steps of its reduced config
           (f32; an MoE at a capacity that drops no token) on
           (N_RANKS / 4, 2, 2) against the unmeshed steps: the families whose weights a
           `local_map` reads (the MoE router and experts, the sLSTM's
           recurrent weights) get their gradients reduced over the batch
           ranks.
  collect  the collective counter on known collectives of a fake group.
"""
import json
import os
import socket
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _hop_cfg():
    from repro_torch.models import registry
    # the reference worker's config (tests/_wire_workers.py)
    return registry.get_reduced_config(
        "suncatcher-lm-100m", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=1, d_ff=64, vocab_size=256)


def _np_tree(prefix, tree, out):
    from repro_torch.train.tree import tree_paths
    for k, v in tree_paths(tree).items():
        out[f"{prefix}/{k}"] = v.detach().cpu().numpy()


def job_hop(rank, world, out_dir, args):
    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.distributed.compression import wire_format_for
    from repro_torch.distributed.hints import on_mesh
    from repro_torch.distributed.sharding import (gather_full, param_shapes,
                                                  param_specs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.train.diloco import (DiLoCoConfig, diloco_init,
                                          outer_step, shard_diloco_state)
    from repro_torch.train.tree import tree_leaves, tree_map
    cfg = _hop_cfg()
    fns = registry.model_fns(cfg)
    dcfg = DiLoCoConfig(n_pods=2)
    mesh = make_mesh((2, 2, 2), device_type="cpu")
    pspecs = param_specs(cfg, fsdp=True, multi_pod=True)
    params = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    result, arrays = {}, {}
    for method in ("int8", "topk"):
        fmt = wire_format_for(param_shapes(cfg), pspecs, mesh, dcfg.n_pods,
                              method=method)
        assert fmt.mesh is not None
        lanes = [int(np.prod(lay.counts)) for lay in
                 tree_leaves(fmt.layout)]
        assert max(lanes) > 1, lanes
        d0 = diloco_init(params, dcfg, compress=method)
        g = torch.Generator().manual_seed(7)
        d0 = {**d0, "pod_params": tree_map(
            lambda x: x + 0.01 * torch.randn(x.shape, generator=g),
            d0["pod_params"])}
        masks = (torch.tensor([1.0, 0.0]), torch.ones(2))
        sim, wire = d0, shard_diloco_state(d0, cfg, mesh)
        counts = []
        for r, mask in enumerate(masks):
            sim = outer_step(sim, dcfg, pod_mask=mask, wire=fmt.simulated())
            with on_mesh(mesh), CollectiveCounter() as cc:
                wire = outer_step(wire, dcfg, pod_mask=mask, wire=fmt)
            counts.append(cc.collective_bytes())
            full = gather_full(wire)
            bad = [k for k in sim if k != "step" and not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(sim[k]),
                                                  tree_leaves(full[k])))]
            assert not bad, f"{method} round {r + 1}: wire != sim at {bad}"
            if rank == 0:
                _np_tree(f"{method}/round{r + 1}", {
                    k: full[k] for k in ("global_params", "outer_m",
                                         "pod_ef")}, arrays)
        if rank == 0:
            _np_tree(f"{method}/d0", d0, arrays)
        result[method] = {"collectives": counts,
                          "n_leaves": len(tree_leaves(params))}
    if rank == 0:
        np.savez(os.path.join(out_dir, "hop.npz"), **arrays)
        _write(out_dir, result)


def job_step(rank, world, out_dir, args):
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.train import diloco, loop
    from repro_torch.train.fault_tolerance import screen_init
    from repro_torch.train.tree import tree_leaves
    bitwise = "bitwise" in args
    shape = (1, 1, 1) if world == 1 else (2, 2, 2)
    mesh = make_mesh(shape, device_type="cpu")
    cfg = registry.get_reduced_config("suncatcher-lm-100m",
                                      compute_dtype="float32")
    fns = registry.model_fns(cfg)
    tcfg = loop.TrainConfig(microbatches=2, warmup_steps=1)
    g = torch.Generator().manual_seed(1)
    k, b, s = 2, 8, 32

    def draw(*lead):       # int32 ids, as the data pipeline makes them
        return torch.randint(0, cfg.vocab_size, lead + (b, s), generator=g,
                             dtype=torch.int32)
    block = {"tokens": draw(k), "labels": draw(k)}
    st0 = loop.init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                                "cpu")
    out = {}

    # per step
    step = loop.make_train_step(cfg, fns, tcfg)
    sstep = loop.make_sharded_train_step(cfg, fns, tcfg, mesh)
    a, sh = st0, st0
    la, lb = [], []
    for i in range(k):
        batch = {n: v[i] for n, v in block.items()}
        a, ma = step(a, batch)
        sh, mb = sstep(sh, batch)
        la.append(ma["loss"].item())
        lb.append(mb["loss"].item())
    out["step"] = _compare(tree_leaves(a), tree_leaves(gather_full(sh)),
                           la, lb)

    # fused K-step blocks
    fused = loop.make_fused_steps(cfg, fns, tcfg)
    sfused = loop.make_sharded_fused_steps(cfg, fns, tcfg, mesh,
                                           drain_every=k)
    thr = torch.tensor([3.0, 5.0])
    fa, _, blk_a = fused(st0, screen_init(8, "cpu"), block, thr)
    fb, _, blk_b = sfused(st0, screen_init(8, "cpu"), block, thr)
    out["fused"] = _compare(tree_leaves(fa), tree_leaves(gather_full(fb)),
                            blk_a["loss"].tolist(), blk_b["loss"].tolist())
    out["fused_equals_step_sharded"] = all(
        torch.equal(x, y) for x, y in zip(tree_leaves(gather_full(fb)),
                                          tree_leaves(gather_full(sh))))

    # a DiLoCo round, int8 wire, supervised with screens
    dcfg = diloco.DiLoCoConfig(n_pods=2, inner_steps=2)
    params = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    d0 = diloco.diloco_init(params, dcfg, compress="int8", screen_window=8)
    batches = {"tokens": draw(2, 2), "labels": draw(2, 2)}
    kw = dict(compress="int8", screen_window=8, supervise=True)
    r0 = diloco.make_diloco_round(cfg, fns, loop.TrainConfig(), dcfg, **kw)
    r1 = diloco.make_diloco_round(cfg, fns, loop.TrainConfig(), dcfg,
                                  mesh=mesh, **kw)
    mask = torch.ones(2)
    x, mx = r0(d0, batches, mask, thr)
    y, my = r1(d0, batches, mask, thr)
    fy = gather_full(y)
    keys = [n for n in ("global_params", "outer_m", "pod_params", "pod_opt",
                        "pod_ef", "screen")]
    out["round"] = _compare(
        [t for n in keys for t in tree_leaves(x[n])],
        [t for n in keys for t in tree_leaves(fy[n])],
        mx["loss"].reshape(-1).tolist(), my["loss"].reshape(-1).tolist())
    out["round"]["metrics_equal"] = all(torch.equal(mx[n], my[n])
                                        for n in mx)
    if bitwise:
        for name in ("step", "fused", "round"):
            assert out[name]["equal"], (name, out[name])
    if rank == 0:
        _write(out_dir, out)


def job_family(rank, world, out_dir, args):
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.train import loop
    from repro_torch.train.tree import tree_leaves
    arch = args[0]
    mesh = make_mesh((world // 4, 2, 2), device_type="cpu")
    cfg = registry.get_reduced_config(arch, compute_dtype="float32")
    if getattr(cfg, "is_moe", False):
        # capacity for every token: a rank counts capacity over its own
        # tokens, one device over the call's (ROADMAP C13), so only a
        # call that drops nothing is the same arithmetic
        from dataclasses import replace
        cfg = replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    fns = registry.model_fns(cfg)
    tcfg = loop.TrainConfig(warmup_steps=1)
    g = torch.Generator().manual_seed(1)
    st = loop.init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                               "cpu")
    step = loop.make_train_step(cfg, fns, tcfg)
    sstep = loop.make_sharded_train_step(cfg, fns, tcfg, mesh)
    a, sh, la, lb = st, st, [], []
    for _ in range(2):
        batch = {n: torch.randint(0, cfg.vocab_size, (8, 32), generator=g,
                                  dtype=torch.int32)
                 for n in ("tokens", "labels")}
        a, ma = step(a, batch)
        sh, mb = sstep(sh, batch)
        la.append(ma["loss"].item())
        lb.append(mb["loss"].item())
    full = gather_full(sh)          # a collective: every rank gathers
    if rank == 0:
        _write(out_dir, _compare(tree_leaves(a), tree_leaves(full), la, lb))


def _compare(xs, ys, la, lb) -> dict:
    """Bitwise flag, the largest difference over all leaves against the
    largest magnitude over all leaves, and the losses."""
    diff = max(float((x.float() - y.float()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(xs, ys))
    scale = max(float(x.float().abs().max()) if x.numel() else 0.0
                for x in xs)
    return {"equal": all(torch.equal(x, y) for x, y in zip(xs, ys)),
            "max_abs_diff": diff, "max_abs": scale, "loss": la,
            "loss_mesh": lb}


def job_collect(rank, world, out_dir, args):
    """Known collectives on a fake group of `world` ranks."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.analysis.collectives import CollectiveCounter
    with CollectiveCounter() as cc:
        q = torch.zeros(3, 256, dtype=torch.int8)
        out = torch.empty(3 * world, 256, dtype=torch.int8)
        dist.all_gather_into_tensor(out, q)
        s = torch.zeros(3, 1)
        dist.all_gather_into_tensor(torch.empty(3 * world, 1), s)
        dist.all_reduce(torch.zeros(10, 7))
        funcol.all_reduce(torch.zeros(4, 4, dtype=torch.bfloat16), "sum",
                          dist.group.WORLD)
        funcol.reduce_scatter_tensor(torch.zeros(world * 6), "sum", 0,
                                     dist.group.WORLD)
        funcol.all_to_all_single(torch.zeros(world * 2, 3, dtype=torch.int32),
                                 None, None, dist.group.WORLD)
    _write(out_dir, cc.collective_bytes())


def _write(out_dir, obj):
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(obj, f)


JOBS = {"hop": job_hop, "step": job_step, "family": job_family,
        "collect": job_collect}
FAKE = {"collect"}


def _rank_main(rank, world, port, job, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        JOBS[job](rank, world, out_dir, args)
    except BaseException:
        # the first failing rank's own traceback (the others then only see
        # their peer's closed connection)
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()


def main():
    job, world, out_dir, args = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4:])
    if job in FAKE:
        from repro_torch.launch.mesh import destroy, init_process_group
        init_process_group("cpu", fake=True, world_size=world)
        try:
            JOBS[job](0, world, out_dir, args)
        finally:
            destroy()
    else:
        import torch.multiprocessing as mp
        mp.spawn(_rank_main, args=(world, _free_port(), job, out_dir, args),
                 nprocs=world, join=True)
    print("MESH-WORKER-OK")


if __name__ == "__main__":
    main()
