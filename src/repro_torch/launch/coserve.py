"""Serving/training co-residency launcher of the PyTorch port: one process
on one device runs DiLoCo rounds and serves live traffic from the
freshest verified outer params.

The orbital cluster that trains also serves.  Here the DiLoCoSupervisor's
round loop and a ServingEngine share the process: after every drained
round the engine pumps its queue, and a rollback-aware ParamPublisher
releases the outer params to `engine.swap_params` once the snapshot
watermark (+ --holdback-rounds) has passed them — a round that is later
rolled back is never served.

  PYTHONPATH=src python -m repro_torch.launch.coserve --device cpu \
      --steps 16 --inner-steps 4 --force-rollback-at 1

  PYTHONPATH=src python -m repro_torch.launch.coserve --full \
      --steps 12 --inner-steps 4 --seq-len 1024 --batch 8 --serve-slots 8 \
      --max-len 512 --requests 16 --max-new-tokens 32 --constellation

Serving plane: --replicas N serves from N engine replicas behind a
ConstellationRouter; the publisher fans verified outer params out to all
of them through the router's plane-wide lockstep `swap_params`.
--serving-constellation routes by the constellation liveness mask (the
training link model's when the pod counts match), and --force-outage-at
takes a chaos schedule (serving/chaos.py); in-flight generations must
fail over, not drop, and the launcher checks that after the run:

  PYTHONPATH=src python -m repro_torch.launch.coserve --device cpu \
      --steps 16 --replicas 2 --max-new-tokens 24 --force-outage-at 2

It runs on the CUDA card unless `--device cpu` is given; with no card and
the default device it exits with an error rather than fall back.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import registry
from repro_torch.serving import (ConstellationRouter, EngineConfig, Request,
                                 ServingEngine, check_forced_outage_contract,
                                 liveness_mask_fn, parse_outage_spec)
from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                               DiLoCoSupervisor, FTConfig, ParamPublisher,
                               PublishConfig, SyntheticLM, TrainConfig,
                               diloco_init, make_diloco_round,
                               outer_wire_bytes, snapshot_global_params)


def run_coserve(sup, eng, requests, n_rounds, *, forced_rollback_at=None,
                blocks_per_round=2, max_steps=10_000):
    """Interleave the supervisor's round loop with the serving engine.

    Per drained round (success or rollback) the engine admits queued
    requests and decodes up to `blocks_per_round` blocks; once training
    reaches `n_rounds` the remaining traffic drains.  Publication happens
    inside the supervisor (its ParamPublisher), not here — this loop only
    moves tokens.  `eng` may be one ServingEngine or a ConstellationRouter
    plane: while training runs, the router's liveness tick is pinned to
    the supervisor's round (a pod masked for training round r is masked
    for serving while round r trains); for the drain the pin is released,
    so the router's own ticks advance any repair window.  Returns the
    finished list."""
    pending = list(requests)
    # a plane admits across its pods: size the queue to the plane
    cap = getattr(eng, "n_pods", 1) * eng.ecfg.max_batch

    def pump(_sup):
        if hasattr(eng, "round_override"):
            eng.round_override = _sup.round
        while pending and len(eng.queue) < cap:
            eng.submit(pending.pop(0))
        for _ in range(blocks_per_round):
            if not (eng.queue or any(s is not None for s in eng.slots)):
                break
            eng.step()

    sup.run(n_rounds, forced_rollback_at=forced_rollback_at, on_round=pump)

    if hasattr(eng, "round_override"):
        eng.round_override = None     # drain on the router's own clock
    steps = 0
    while (pending or eng.queue
           or any(s is not None for s in eng.slots)) and steps < max_steps:
        while pending and len(eng.queue) < cap:
            eng.submit(pending.pop(0))
        eng.step()
        steps += 1
    return eng.finished


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="suncatcher-lm-100m",
                    help=f"arch id; ported: {registry.ARCH_IDS}")
    ap.add_argument("--full", action="store_true",
                    help="the config's published widths (default: the "
                         "reduced smoke config)")
    ap.add_argument("--steps", type=int, default=24,
                    help="total inner training steps (rounds = "
                         "ceil(steps / inner-steps))")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="training batch per pod")
    ap.add_argument("--diloco-pods", type=int, default=2)
    ap.add_argument("--inner-steps", type=int, default=4,
                    help="DiLoCo H: local steps between outer syncs")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="steps between supervisor snapshots — the "
                         "publication watermark advances on this cadence")
    ap.add_argument("--serve-slots", type=int, default=2,
                    help="serving engine decode slots (EngineConfig."
                         "max_batch), per replica")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving-pod engine replicas behind the liveness "
                         "router (1 = a single engine, no router)")
    ap.add_argument("--serving-constellation", action="store_true",
                    help="route serving traffic by the constellation "
                         "liveness mask (the training link model's when "
                         "the pod counts match)")
    ap.add_argument("--force-outage-at", type=str, default=None,
                    help="chaos schedule 'AT[:POD[:TICKS]][,...]': strike "
                         "pod POD ('*' or omitted = busiest) at router "
                         "tick AT for TICKS ticks (omitted = rest of "
                         "run); in-flight generations must fail over, "
                         "not drop (needs --replicas >= 2)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens decoded per host round-trip")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--publish-every", type=int, default=1,
                    help="stage a publish candidate every N rounds")
    ap.add_argument("--holdback-rounds", type=int, default=1,
                    help="further completed rounds a publish candidate "
                         "must survive, on top of the snapshot-watermark "
                         "gate")
    ap.add_argument("--constellation", action="store_true",
                    help="derive pod liveness from the orbital/ISL/"
                         "radiation stack")
    ap.add_argument("--force-rollback-at", type=int, default=None,
                    help="force one whole-round rollback at this round "
                         "(the publisher must drop, not serve, it)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default "
                         "cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu to run the plain "
                         f"kernels on the CPU)")
    if args.force_outage_at is not None and args.replicas < 2:
        raise SystemExit("--force-outage-at needs --replicas >= 2 (a "
                         "one-pod plane has nowhere to migrate)")
    if args.arch not in registry.ARCH_IDS:
        raise SystemExit(f"unknown --arch {args.arch!r}; ported: "
                         f"{registry.ARCH_IDS}")
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_reduced_config(args.arch))
    fns = registry.model_fns(cfg)
    dcfg = DiLoCoConfig(n_pods=args.diloco_pods,
                        inner_steps=args.inner_steps)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3),
                       warmup_steps=max(2, args.steps // 10),
                       total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.batch), device)
    window = FTConfig(checkpoint_dirs=()).gnorm_window
    params = fns.init(torch.Generator().manual_seed(0), cfg, device)
    d_state = diloco_init(params, dcfg, screen_window=window)
    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, data=data,
                            screen_window=window, supervise=True)

    liveness = None
    if args.constellation:
        from repro_torch.core.isl import (ConstellationLinkModel,
                                          LivenessConfig)
        liveness = ConstellationLinkModel(cfg=LivenessConfig(
            n_pods=dcfg.n_pods, outer_wire_bytes=outer_wire_bytes(params)),
            device=device)

    # the engine(s) serve the round-0 globals until the first publish,
    # from their own copy
    ecfg = EngineConfig(max_batch=args.serve_slots, max_len=args.max_len,
                        decode_block=args.decode_block)
    params0 = snapshot_global_params(d_state)
    if args.replicas > 1 or args.serving_constellation:
        mask_fn = None
        if args.serving_constellation:
            # the serving twin of the training mask: the same link model
            # when the pod counts match, so one masked pod silences both
            if liveness is not None and dcfg.n_pods == args.replicas:
                serve_model = liveness
            else:
                from repro_torch.core.isl import (ConstellationLinkModel,
                                                  LivenessConfig)
                serve_model = ConstellationLinkModel(cfg=LivenessConfig(
                    n_pods=args.replicas,
                    outer_wire_bytes=outer_wire_bytes(params)),
                    device=device)
            mask_fn = liveness_mask_fn(serve_model)
        forced = (parse_outage_spec(args.force_outage_at)
                  if args.force_outage_at is not None else None)
        eng = ConstellationRouter(
            [ServingEngine(cfg, fns, params0, ecfg)
             for _ in range(args.replicas)],
            mask_fn=mask_fn, forced_outage=forced)
    else:
        eng = ServingEngine(cfg, fns, params0, ecfg)
    publisher = ParamPublisher(
        eng.swap_params,
        PublishConfig(publish_every=args.publish_every,
                      holdback_rounds=args.holdback_rounds))

    rng = np.random.default_rng(0)
    reqs = [Request(uid=uid,
                    prompt=rng.integers(
                        0, cfg.vocab_size,
                        size=int(rng.integers(4, 16))).astype(np.int32),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature)
            for uid in range(args.requests)]

    n_rounds = -(-args.steps // dcfg.inner_steps)
    forced = ([args.force_rollback_at]
              if args.force_rollback_at is not None else None)
    b1, b3 = decode_attention.launches, flash_attention.launches
    with tempfile.TemporaryDirectory() as d:
        ft = FTConfig(checkpoint_dirs=(os.path.join(d, "replica-a"),
                                       os.path.join(d, "replica-b")),
                      checkpoint_every=args.checkpoint_every, keep=1)
        sup = DiLoCoSupervisor(rnd, d_state, dcfg, ft, liveness=liveness,
                               publisher=publisher)
        t0 = time.perf_counter()
        done = run_coserve(sup, eng, reqs, n_rounds,
                           forced_rollback_at=forced)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0

    if publisher.published_round > sup.verified_round:
        raise RuntimeError(
            f"published round {publisher.published_round} past the "
            f"verification watermark {sup.verified_round}")
    losses = sup.mean_losses
    print(f"{cfg.name}: co-resident {len(sup.history)} DiLoCo rounds x "
          f"H={dcfg.inner_steps} ({dcfg.n_pods} pods) + {len(done)} "
          f"requests served in {dt:.1f}s on {device}, mean pod loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"  publish: {publisher.stats['staged']} staged, "
          f"{publisher.stats['published']} published (newest round "
          f"{publisher.published_round}/{sup.round}), "
          f"{publisher.stats['dropped_rollback']} dropped by rollback, "
          f"{sup.stats['rollbacks']} whole-round rollbacks")
    launches = (f"kernel launches: decode attention "
                f"{decode_attention.launches - b1}, flash attention "
                f"{flash_attention.launches - b3}")
    if isinstance(eng, ConstellationRouter):
        s = eng.plane_stats()
        print(f"  serve: plane of {args.replicas} replicas, "
              f"{s['engines']['tokens'] / dt:.0f} tok/s co-resident, "
              f"{s['swaps']} plane-wide param swaps (v"
              f"{eng.params_version}), {s['migrated_slots']} slots "
              f"migrated ({s['pointer_flips']} pointer flips), "
              f"{s['masked_pod_ticks']} masked pod-ticks | {launches}")
        if args.force_outage_at is not None:
            check_forced_outage_contract(eng, done, args.requests)
            print(f"  outage '{args.force_outage_at}': zero drops, "
                  f"{s['migrated_slots']} slots failed over")
    else:
        s = eng.stats
        print(f"  serve: {s['tokens'] / dt:.0f} tok/s co-resident, "
              f"{s['swaps']} live param swaps (engine "
              f"v{eng.params_version}) | {launches}")


if __name__ == "__main__":
    main()
