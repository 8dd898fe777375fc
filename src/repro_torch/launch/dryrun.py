"""Dry run of the production meshes: rank 0's program under a fake process
group, the torch counterpart of the reference's ahead-of-time compile of
the per-device program (`repro.launch.dryrun`).

For each (arch x shape) cell this script:
  1. sets up a fake process group of the mesh's size (256 ranks for the
     (16, 16) single-pod mesh, 512 for (2, 16, 16)) and runs rank 0:
     collectives are recorded but move nothing;
  2. builds rank 0's shard of the state as DTensors placed by
     `repro_torch.distributed.sharding` (train_4k: the train state,
     ZeRO-3 on "data" and tensor parallel on "model"; prefill_32k: bf16
     params; decode_32k / long_500k: bf16 params and the serving cache);
  3. runs the step: train_4k -> make_sharded_train_step (fwd + bwd +
     AdamW), prefill_32k -> forward, decode / long -> decode_step (one
     token against a seq_len cache or recurrent state);
  4. records, per rank: peak memory by category (MemTracker), FLOPs
     (the aten ops rank 0 runs, counted by `LocalFlopCounter`, plus the
     kernels' own counts, `kernels/_boundary.COUNTS`), HBM bytes (each
     aten op's inputs and outputs, `LocalByteCounter`, plus the kernels'
     own), collective bytes, in total and by the line of the port that
     issued them (`analysis.collectives`), the measured
     roofline of those counts and the analytic roofline, both priced at
     `--chip`, into a JSON under `--out` (default build/dryrun/).

The transformer cells take the reference's sequence parallelism on
"model": the residual stream shards its sequence there (Megatron-SP);
where the heads do not divide the axis q keeps that split and each model
rank runs its query rows at their offset, so the ranks of a causal split
do unequal work (rank 0 the least): a cell records the counted rank's
query offset and the kernels' FLOPs of every model rank, from the fake
count at each rank's offset, beside rank 0's; the decode cells shard the
KV cache's length over "model".  The transformer and RG-LRU families run
with `attn_impl="chunked"`, as the reference's dry run sets it: the
attention calls no kernel takes (recurrentgemma's windowed prefill) run
the online softmax over KV blocks, each block's step recomputed in the
backward pass, and a config of those families without the field fails
the build.

By default nothing is allocated: the state and the step run on fake
tensors (FakeTensorMode, device "cpu"), so the kernels take their fake
path and the run fits the CPU.  `--device cuda` runs rank 0's program
for real on the card (random weights), the collectives still fake, and
adds `torch.cuda.max_memory_allocated`.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  python -m repro_torch.launch.dryrun --arch xlstm-350m   # its every shape
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

DiLoCo outer-sync cells (--outer-sync): rank 0 of the (2, 16, 16) mesh
runs only the masked Nesterov outer step, the FSO pod hop, at the demo
LM's full width, with the int8 / top-k error-feedback wire hop
(`train/diloco.py::_wire_shard_hop`), and records the per-rank bytes by
op and dtype beside the `outer_wire_bytes` prediction.  `--simulated`
runs the simulated hop instead, which on a mesh first gathers the f32
deltas.  `--check` compares like for like: `per_pod_wire_bytes`, the sum
over one pod's ranks of each rank's own payload, against
`budget_factor` x `outer_wire_bytes` (a per-pod figure):
  python -m repro_torch.launch.dryrun --outer-sync --compress int8 --check
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.analytic import analytic_roofline, useful_flops
from repro_torch.analysis.collectives import (CollectiveCounter,
                                              HostSyncCounter,
                                              collective_bytes_loop_aware,
                                              sync_debug_warnings)
from repro_torch.analysis.roofline import roofline
from repro_torch.core.system import H100_SXM, ChipSpec
from repro_torch.distributed.hints import on_mesh
from repro_torch.distributed.sharding import (SDS, batch_axes, batch_specs,
                                              cache_specs, make_local,
                                              param_shapes, param_specs,
                                              train_state_specs)
from repro_torch.kernels import _boundary
from repro_torch.launch.mesh import (destroy, init_process_group,
                                     make_production_mesh)
from repro_torch.models import registry
from repro_torch.train.loop import TrainConfig, make_sharded_train_step
from repro_torch.train.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

# Gradient-accumulation factor per arch for train_4k (the reference's):
# keeps the per-device activation-checkpoint stacks within memory
TRAIN_MICROBATCHES = {
    "command-r-35b": 2,
    "qwen2.5-32b": 2,
    "stablelm-12b": 2,
    "minicpm-2b": 2,
    "musicgen-medium": 2,
    "qwen3-moe-30b-a3b": 4,
    "granite-moe-1b-a400m": 2,
    "recurrentgemma-2b": 2,
    "xlstm-350m": 1,
    "qwen2-vl-2b": 1,
    "suncatcher-lm-100m": 1,
}

CHIPS = {"default": ChipSpec(), "h100": H100_SXM}

# the model families whose attention reads the config's `attn_impl`: the
# dry run sets it to "chunked" there, as the reference's does on every
# arch (xLSTM's config keeps no such field: the reference's is unused)
ATTN_IMPL_FAMILIES = ("repro_torch.models.transformer",
                      "repro_torch.models.rglru")


def _dev(device: str) -> str:
    """The device type of the rank's tensors and mesh: the card for a
    real run; "cpu" for a fake run, on any machine (fake tensors hold no
    memory, so their device only names it: a CPU-only torch cannot make
    fake CUDA tensors of every op, and MemTracker's split of fake CUDA
    tensors between devices differs between torch versions)."""
    return "cuda" if device == "cuda" else "cpu"


class LocalByteCounter(TorchDispatchMode):
    """HBM bytes of the aten ops this rank runs, as `LocalFlopCounter`
    takes its ops: each op's tensor inputs read once and outputs written
    once.  Views, allocations and collectives (the wire term counts
    those) move nothing here; a kernel's bytes come from its fake count
    (`_boundary.COUNTS`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is self._entry_fake and _moves_bytes(func):
            name = func._schema.name.split("::")[-1]
            if name in _SLICE_WRITES:
                # an in-place write of a slice: the indices and values
                # read, as many bytes written, the rest of `self` untouched
                args, out = args[1:], args[_SLICE_WRITES[name]]
            self.bytes += sum(t.numel() * t.element_size() for t in
                              tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


# in-place ops that write a slice of their first argument -> the index of
# the argument that holds the values
_SLICE_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
                 "scatter_": 3}


def _moves_bytes(func) -> bool:
    if func.namespace != "aten" or func.is_view:
        return False
    name = func._schema.name.split("::")[-1]
    return not (name.startswith("empty") or name in ("detach", "alias",
                                                     "lift_fresh"))


class LocalFlopCounter(TorchDispatchMode):
    """FLOPs of the aten ops this rank runs: an op on DTensors is handed
    back to DTensor (NotImplemented), so what is counted is the local op
    on the rank's own shards, by torch's FLOP formulas.  DTensor's own
    shape inference runs ops at global shapes; `measure` gives it a fake
    mode of its own, and ops under another fake mode than the one
    active at entry are not counted (MemTracker's rule, which so skips
    their memory too)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = self.registry.get(func._overloadpacket)
        if fn is not None and active_fake_mode() is self._entry_fake:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        return out


# --------------------------------------------------------------------------
# state construction
# --------------------------------------------------------------------------
def _maker(device: str, vocab: int, seed: int = 0):
    """make(shape, dtype) for a rank's local shards: uninitialised under
    FakeTensorMode; on the card, small normal floats and ids below
    `vocab` (a random model: the dry run measures, it does not learn)."""
    gen = None

    def make(shape, dtype):
        nonlocal gen
        if device != "cuda":
            return torch.empty(shape, dtype=dtype, device=_dev(device))
        if gen is None:
            gen = torch.Generator(device="cuda").manual_seed(seed)
        if dtype.is_floating_point:
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 0.02).to(dtype)
        return torch.randint(0, vocab, shape, generator=gen, device="cuda",
                             dtype=dtype)
    return make


def _as(shapes, dtype):
    return tree_map(lambda s: SDS(s.shape, dtype), shapes)


def _tok_shape(cfg, ikind, b, s):
    return (b, cfg.n_codebooks, s) if ikind == "codebooks" else (b, s)


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               device: str = "fake", reduced: bool = False, dims=None):
    """Returns (fn, args, meta): rank 0's step on `mesh` and its local
    DTensor arguments.  `reduced` takes the arch's reduced config and
    `dims` (seq_len, global_batch) overrides the shape's (the tests'
    small cells)."""
    seq_len, global_batch, kind = registry.SHAPES[shape_name]
    if dims is not None:
        seq_len, global_batch = dims
    train_cell = kind == "train"
    get = registry.get_reduced_config if reduced else registry.get_config
    overrides = {"loss_chunk": min(1024, seq_len)}
    base = get(arch)
    if hasattr(base, "fsdp_hints"):
        overrides["fsdp_hints"] = train_cell
    if registry.family(base) in ATTN_IMPL_FAMILIES:
        # the reference's dry-run setting: the calls no kernel takes
        # (windowed prefill) run the online-softmax over KV blocks; a
        # config without the field makes `get` raise TypeError
        overrides["attn_impl"] = "chunked"
    cfg = get(arch, **overrides)
    fns = registry.model_fns(cfg)
    ikind = registry.input_kind(arch)
    make = _maker(device, cfg.vocab_size)
    pspecs = param_specs(cfg, fsdp=train_cell, multi_pod=multi_pod)
    pshapes = param_shapes(cfg)
    tokens_n = global_batch * (seq_len if kind != "decode" else 1)
    meta = {"arch": arch, "shape": shape_name, "kind": kind,
            "seq_len": seq_len, "global_batch": global_batch,
            "multi_pod": multi_pod, "tokens_per_step": tokens_n,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "attn_impl": getattr(cfg, "attn_impl", None)}
    bspec = (batch_axes(multi_pod),)

    if kind == "train":
        tcfg = TrainConfig(microbatches=TRAIN_MICROBATCHES.get(arch, 1))
        meta["microbatches"] = tcfg.microbatches
        i32 = SDS((), torch.int32)
        state_shapes = {"params": pshapes,
                        "opt": {"m": _as(pshapes, torch.float32),
                                "v": _as(pshapes, torch.float32),
                                "step": i32},
                        "step": i32}
        state = make_local(state_shapes, train_state_specs(pspecs), mesh,
                           make)
        tok = SDS(_tok_shape(cfg, ikind, global_batch, seq_len),
                  torch.int64)
        bshapes = {"tokens": tok, "labels": tok}
        if ikind == "vlm":
            bshapes["positions"] = SDS((3, global_batch, seq_len),
                                       torch.int64)
        batch = make_local(bshapes, batch_specs(ikind, multi_pod), mesh,
                           make)
        step = make_sharded_train_step(cfg, fns, tcfg, mesh,
                                       multi_pod=multi_pod)
        return step, (state, batch), meta

    params = make_local(_as(pshapes, cfg.cdtype), pspecs, mesh, make)
    if kind == "prefill":
        tokens = make_local(SDS(_tok_shape(cfg, ikind, global_batch,
                                           seq_len), torch.int64),
                            bspec, mesh, make)

        def prefill(params, tokens):
            with torch.no_grad(), on_mesh(mesh):
                return fns.forward(params, tokens, cfg)
        return prefill, (params, tokens), meta

    # decode / long-context decode: one token against a seq_len cache
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        cache_fake = fns.init_cache(cfg, global_batch, seq_len,
                                    device=_dev(device))
    cshapes = _sds_tree(cache_fake)
    cspecs = cache_specs(cfg, multi_pod=multi_pod)
    # transformer KV cache: shard its length over "model" (sequence-
    # parallel decode attention), as the reference's dry run places it;
    # recurrent states keep their channel specs
    if "k" in cshapes:
        cspecs = {"k": (None, bspec[0], "model"),
                  "v": (None, bspec[0], "model"), "pos": ()}
    cache = make_local(cshapes, cspecs, mesh, _cache_maker(make))
    if "k" in cshapes:
        meta["kv_cache_bytes"] = sum(
            math.prod(cshapes[n].shape) * cshapes[n].dtype.itemsize
            for n in ("k", "v"))
        meta["kv_cache_bytes_per_rank"] = sum(
            _boundary.nbytes(cache[n].to_local()) for n in ("k", "v"))
    # the position is one scalar every rank reads
    cache["pos"] = cache["pos"].to_local()
    tokens = make_local(SDS(_tok_shape(cfg, ikind, global_batch, 1),
                            torch.int64), bspec, mesh, make)

    def serve_step(params, cache, tokens):
        with torch.no_grad(), on_mesh(mesh):
            return fns.decode_step(params, cache, tokens, cfg)
    return serve_step, (params, cache, tokens), meta


def _cache_maker(make):
    """A cache starts empty: zeros (and position 0) on the card."""
    def mk(shape, dtype):
        t = make(shape, dtype)
        return t if _boundary.is_fake(t) else t.zero_()
    return mk


def _sds_tree(tree):
    if isinstance(tree, dict):
        return {k: _sds_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sds_tree(v) for v in tree)
    return SDS(tuple(tree.shape), tree.dtype)


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------
def _locals(tree) -> list:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif torch.is_tensor(t):
            out.append(t.to_local() if _boundary.is_dtensor(t) else t)
    walk(tree)
    return out


@contextlib.contextmanager
def _separate_shape_inference():
    """DTensor infers an op's output metadata by running it on fake
    tensors of the global shapes, under the fake mode already active if
    there is one (the dry run's own).  Inside this block it gets a fresh
    fake mode instead, so that the counters and MemTracker, which skip
    ops under any other fake mode than their entry one, see only the
    rank's own work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                   None)
    if orig is None:
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"_propagate_tensor_meta_non_cached, so DTensor's global-shape "
            f"inference cannot be kept out of the rank's counts")

    def own_mode(self, *args, **kwargs):
        with FakeTensorMode():
            return orig(self, *args, **kwargs)
    ShardingPropagator._propagate_tensor_meta_non_cached = own_mode
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _rank_mem_tracker():
    """A MemTracker that counts only the ops run under the fake mode that
    was active at its entry (None on the card), as torch 2.13's own does:
    torch 2.11's also counted DTensor's shape inference at global shapes
    (stablelm-12b train_4k, rank 0 of (16, 16): 64.47 GiB against the
    rank's 20.73 measured on the card)."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class RankMemTracker(MemTracker):
        def __enter__(self):
            self._rank_fake_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if active_fake_mode() is not self._rank_fake_mode and not any(
                    issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RankMemTracker()


def measure(fn, args, device: str) -> dict:
    """Run fn(*args) once under the counters: peak memory by category,
    local FLOPs plus the kernels' counts, collectives, seconds; on the
    card also max_memory_allocated."""
    _boundary.reset_counts()
    mt = _rank_mem_tracker()
    mt.track_external(*_locals(args))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state = sum(t.numel() * t.element_size() for t in _locals(args))
    flops, coll = LocalFlopCounter(), CollectiveCounter()
    nbytes = LocalByteCounter()
    t0 = time.perf_counter()
    with _separate_shape_inference(), mt, flops, nbytes, coll:
        fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak")
    mem = {str(dev): {str(k): int(v) for k, v in snap.items()}
           for dev, snap in peak.items()}
    kernels = {k: dict(v) for k, v in _boundary.COUNTS.items()}
    splits = _boundary.SPLITS["calls"]
    out = {"seconds": seconds, "memory_peak": mem,
           "memory_peak_bytes": max((v.get("Total", 0)
                                     for v in mem.values()), default=0),
           "flops": {"aten": flops.flops,
                     "kernels": sum(v["flops"] for v in kernels.values()),
                     "per_kernel": kernels},
           "bytes": {"aten": nbytes.bytes,
                     "kernels": sum(v["bytes"] for v in kernels.values())},
           "query_splits": splits,
           "collectives": {**coll.collective_bytes(),
                           "by_site": coll.by_site()},
           "collectives_loop_aware": collective_bytes_loop_aware(
               coll.records)}
    out["flops"]["total"] = out["flops"]["aten"] + out["flops"]["kernels"]
    out["bytes"]["total"] = out["bytes"]["aten"] + out["bytes"]["kernels"]
    if device == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
        out["max_memory_allocated"] = peak
        # the step's own peak: its state and what it allocates, not what
        # the process held before
        out["own_peak_bytes"] = peak - before + state
    return out


def _fake_ctx(device: str):
    if device == "cuda":
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _mesh_setup(multi_pod: bool, device: str, mesh_shape=None, rank=0):
    shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    destroy()
    init_process_group(_dev(device), fake=True,
                       world_size=math.prod(shape), rank=rank)
    return make_production_mesh(multi_pod=multi_pod, shape=shape,
                                device_type=_dev(device))


def _write(result: dict, out_dir: str, tag: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def model_rank_flops(m: dict, model_shards: int) -> dict:
    """The kernels' FLOPs of each model rank: a kernel whose fake calls
    ran inside a query split counted every rank's work at its own offset;
    any other does the same work on every model rank."""
    per = [0] * model_shards
    for k in m["flops"]["per_kernel"].values():
        by = k.get("flops_by_model_rank") or [k["flops"]] * model_shards
        per = [a + b for a, b in zip(per, by)]
    mean = sum(per) / model_shards
    return {"kernels_by_model_rank": per,
            "kernels_heaviest_model_rank": max(per),
            "kernels_mean_model_rank": mean,
            "total_mean_model_rank": m["flops"]["aten"] + mean}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, device: str = "fake",
             chip: str = "default", verbose: bool = True, mesh_shape=None,
             reduced: bool = False, dims=None, rank: int = 0):
    """Build and measure one cell; write and return its JSON dict.
    `mesh_shape`, `reduced` and `dims` make the tests' small cells;
    `rank` counts another rank's program than rank 0's."""
    t0 = time.perf_counter()
    mesh = _mesh_setup(multi_pod, device, mesh_shape, rank)
    try:
        with _fake_ctx(device):
            fn, args, meta = build_cell(arch, shape_name, mesh, multi_pod,
                                        device, reduced, dims)
            t_build = time.perf_counter() - t0
            m = measure(fn, args, device)
        model_rank = mesh.get_coordinate()[mesh.mesh_dim_names.index(
            "model")]
    finally:
        destroy()
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    ms = sizes.get("model", 1)
    split = m.pop("query_splits") > 0
    m["flops"].update(model_rank_flops(m, ms))
    # the counted rank's query rows start here (a query split only)
    m["rank"] = rank
    m["query_offset"] = model_rank * meta["seq_len"] // ms if split \
        else None
    chips = math.prod(sizes.values())
    spec = CHIPS[chip]
    get = registry.get_reduced_config if reduced else registry.get_config
    analytic = analytic_roofline(
        get(arch), meta["kind"], meta["global_batch"],
        meta["seq_len"], chips=chips,
        data_shards=sizes.get("data", 1) * sizes.get("pod", 1),
        model_shards=sizes.get("model", 1),
        wire_bytes_per_device=m["collectives_loop_aware"]["wire_bytes"],
        microbatches=meta.get("microbatches", 1), chip=spec)
    terms = roofline({"flops": m["flops"]["total"],
                      "bytes accessed": m["bytes"]["total"]},
                     m["collectives_loop_aware"]["wire_bytes"], chips=chips,
                     model_flops=useful_flops(get(arch), meta["kind"],
                                              meta["global_batch"],
                                              meta["seq_len"]), chip=spec)
    measured = {"compute_s": terms.compute_s, "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "step_time_s": terms.step_time_s,
                "model_flops": terms.model_flops,
                "utility_ratio": terms.utility_ratio, "mfu": terms.mfu}
    result = {**meta, "chips": chips, "mesh": sizes, "device": device,
              "reduced": reduced, "chip": spec.name,
              "chip_hbm_capacity_bytes": spec.hbm_capacity_bytes,
              "build_s": round(t_build, 2), **m, "roofline": measured,
              "analytic": analytic}
    tag = f"{arch}_{shape_name}_{'multi' if multi_pod else 'single'}"
    _write(result, out_dir, tag)
    if verbose:
        print(f"[OK] {tag}: {m['seconds']:.1f}s, peak "
              f"{m['memory_peak_bytes'] / 2**30:.2f} GiB/rank, "
              f"{m['flops']['total'] / 1e12:.3f} TFLOP/rank (mean over "
              f"model ranks {m['flops']['total_mean_model_rank'] / 1e12:.3f}"
              f"; analytic "
              f"{analytic['flops_per_device'] / 1e12:.3f}), wire "
              f"{m['collectives']['wire_bytes'] / 2**20:.1f} MiB/rank, "
              f"dominant={analytic['dominant']}", flush=True)
    return result


# --------------------------------------------------------------------------
# the DiLoCo outer sync
# --------------------------------------------------------------------------
def per_pod_bytes(coll: dict, ranks_per_pod: int, pod_group_size: int
                  ) -> int:
    """The sum over one pod's ranks of each rank's own payload.  A rank's
    all-gather result holds the payloads of the `pod_group_size` ranks of
    its pod group, its own one of them; an all-reduce's buffer is the
    rank's own.  Every rank of a pod ships the same bytes (the specs
    shard evenly), so the pod's sum is one rank's own payload times the
    pod's ranks."""
    own = coll["bytes"].get("all-gather", 0) // pod_group_size \
        + coll["bytes"].get("all-reduce", 0)
    return own * ranks_per_pod


def check_outer_sync(result: dict):
    """The wire gate, like for like: per pod against per pod.  Raises
    SystemExit when `per_pod_wire_bytes` exceeds `budget_factor` x the
    predicted per-pod payload."""
    per_pod = result["per_pod_wire_bytes"]
    limit = result["budget_factor"] * \
        result["predicted_outer_wire_bytes_per_pod"]
    if per_pod > limit:
        raise SystemExit(
            f"outer-sync wire budget EXCEEDED: {per_pod} B per pod is "
            f"{per_pod / result['predicted_outer_wire_bytes_per_pod']:.3f}x"
            f" the predicted payload (budget {result['budget_factor']}x)")


def run_outer_sync_cell(arch: str = "suncatcher-lm-100m",
                        compress: str | None = "int8",
                        topk_frac: float = 0.01, n_pods: int = 2,
                        out_dir: str | None = RESULTS_DIR,
                        verbose: bool = True, simulated: bool = False,
                        device: str = "fake", reduced: bool = False,
                        mesh_shape=None):
    """Rank 0 of the (2, 16, 16) mesh (or `mesh_shape`) runs the DiLoCo
    outer step alone (the inner H steps are pod-local by construction) at
    the arch's full width (or its reduced config), on a fake group;
    returns the JSON dict (the reference's schema plus
    `per_pod_wire_bytes`, `host_syncs`, `seconds` and `device`), written
    under `out_dir` unless it is None."""
    from repro_torch.distributed.compression import wire_format_for
    from repro_torch.distributed.sharding import diloco_specs
    from repro_torch.train.diloco import (LINT_BUDGET, DiLoCoConfig,
                                          outer_step, outer_wire_bytes)
    comp = None if compress in (None, "none") else compress
    cfg = (registry.get_reduced_config if reduced else
           registry.get_config)(arch)
    dcfg = DiLoCoConfig(n_pods=n_pods)
    pshapes = param_shapes(cfg)
    pspecs = param_specs(cfg, fsdp=True, multi_pod=True)
    mesh = _mesh_setup(True, device, mesh_shape)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    wire = None
    if comp is not None:
        wire = wire_format_for(pshapes, pspecs, mesh, n_pods, method=comp,
                               topk_frac=topk_frac)
    pod = lambda t: tree_map(                               # noqa: E731
        lambda s: SDS((n_pods,) + tuple(s.shape), s.dtype), t)
    f32 = _as(pshapes, torch.float32)
    d_shapes = {"global_params": pshapes, "outer_m": f32,
                "pod_params": pod(pshapes)}
    if comp is not None:
        d_shapes["pod_ef"] = pod(f32)
    specs = diloco_specs(pspecs, compress=comp is not None)
    t0 = time.perf_counter()
    try:
        with _fake_ctx(device):
            make = _maker(device, cfg.vocab_size)
            d_state = make_local(d_shapes, {k: specs[k] for k in d_shapes},
                                 mesh, make)
            d_state["step"] = torch.zeros((), dtype=torch.int32,
                                          device=_dev(device))
            mask = torch.ones((n_pods,), device=_dev(device))
            host = HostSyncCounter(_dev(device))
            warned = []

            def hop(d):
                with on_mesh(mesh), sync_debug_warnings() as seen, host:
                    if simulated and comp is not None:
                        out = _simulated_outer(d, dcfg, mask, comp,
                                               topk_frac, wire)
                    else:
                        out = outer_step(d, dcfg, pod_mask=mask,
                                         compress=comp, topk_frac=topk_frac,
                                         wire=wire)
                warned.extend(seen)
                return out
            m = measure(hop, (d_state,), device)
    finally:
        destroy()
    dt = time.perf_counter() - t0
    coll = m["collectives"]
    predicted = outer_wire_bytes(pshapes, compress=comp,
                                 topk_frac=topk_frac, wire=wire)
    ranks_per_pod = sizes["data"] * sizes["model"]
    per_pod = per_pod_bytes(coll, ranks_per_pod, sizes["pod"])
    factor = LINT_BUDGET["outer_wire_budget_factor"]
    result = {
        "arch": arch, "compress": compress or "none", "n_pods": n_pods,
        "wire_format": wire is not None or comp is None,
        "simulated": bool(simulated and comp is not None),
        "mesh": sizes, "device": device, "seconds": round(dt, 3),
        "step_seconds": m["seconds"],
        "params": cfg.param_count(),
        "predicted_outer_wire_bytes_per_pod": predicted,
        "per_rank_wire_bytes": coll["wire_bytes"],
        "per_pod_wire_bytes": per_pod,
        "per_pod_over_predicted": round(per_pod / predicted, 4)
        if predicted else float("inf"),
        "budget_factor": factor,
        "within_budget": bool(per_pod <= factor * predicted),
        "collectives": coll,
        "collectives_loop_aware": m["collectives_loop_aware"],
        "host_syncs": host.host_syncs(),
        "memory_peak_bytes": m["memory_peak_bytes"],
        "note": ("per_pod_wire_bytes: one rank's own payload (its "
                 "all-gather result over the pod group's ranks, or its "
                 "all-reduce buffer) times the pod's ranks, against the "
                 "per-pod prediction"),
    }
    if "max_memory_allocated" in m:
        result["max_memory_allocated"] = m["max_memory_allocated"]
    if device == "cuda":
        result["sync_debug_warnings"] = len(warned)
    tag = f"diloco_outer_{arch}_{compress or 'none'}_multi"
    if simulated and comp is not None:
        tag += "_simulated"
    if out_dir is not None:
        _write(result, out_dir, tag)
    if verbose:
        by = "; ".join(f"{k}: " + ", ".join(f"{d}={b}" for d, b in
                                            sorted(v.items()))
                       for k, v in sorted(coll["bytes_by_dtype"].items()))
        print(f"[OK] {tag}: {dt:.1f}s, per rank {by}; per pod "
              f"{per_pod} B vs predicted {predicted} B "
              f"({result['per_pod_over_predicted']}x, budget {factor}x)",
              flush=True)
    return result


def _simulated_outer(d, dcfg, mask, comp, topk_frac, wire):
    """The simulated hop on a mesh: the pods' deltas gathered whole in f32
    (what a simulation over sharded state has to move), then the
    pod-local compressor in the wire layout."""
    from repro_torch.train.diloco import _wire_sim_hop
    gp = tree_map(lambda x: x.full_tensor(), d["global_params"])
    pp = tree_map(lambda x: x.full_tensor(), d["pod_params"])
    ef = tree_map(lambda x: x.full_tensor(), d["pod_ef"])
    deltas = tree_map(lambda g, p: torch.where(
        mask.reshape((-1,) + (1,) * g.dim()) > 0,
        g.float()[None] - p.float(), 0.0), gp, pp)
    return _wire_sim_hop(deltas, ef, mask, torch.clamp_min(mask.sum(), 1.0),
                         comp, wire.block, topk_frac, wire.layout)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="one arch: --shape's cell, or all of its shapes")
    ap.add_argument("--shape", default=None,
                    choices=sorted(registry.SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every cell of registry.cells()")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="fake", choices=["fake", "cuda"],
                    help="fake: FakeTensorMode, nothing allocated "
                         "(default); cuda: rank 0's program on the card")
    ap.add_argument("--chip", default="default", choices=sorted(CHIPS),
                    help="the chip the analytic roofline is priced for: "
                         "the paper's modelled chip (default) or the H100")
    ap.add_argument("--outer-sync", action="store_true",
                    help="the DiLoCo outer sync alone on the (2,16,16) "
                         "mesh, with its collective bytes")
    ap.add_argument("--compress", default="int8",
                    choices=["none", "int8", "topk"],
                    help="outer-sync wire compression (--outer-sync only)")
    ap.add_argument("--simulated", action="store_true",
                    help="the simulated hop instead of the wire hop "
                         "(--outer-sync only)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if the per-pod payload exceeds the "
                         "budget factor x the per-pod prediction "
                         "(--outer-sync only)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if args.outer_sync:
        result = run_outer_sync_cell(arch=args.arch or "suncatcher-lm-100m",
                                     compress=args.compress,
                                     out_dir=args.out,
                                     simulated=args.simulated,
                                     device=args.device)
        if args.check:
            check_outer_sync(result)
        return

    if args.all:
        cells = registry.cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = registry.cells([args.arch])
    else:
        raise SystemExit("--arch [--shape], or --all")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, tag + ".json")):
                print(f"[SKIP] {tag}", flush=True)
                continue
            try:
                run_cell(arch, shape, mp, args.out, args.device, args.chip)
            except Exception as e:          # noqa: BLE001 — listed below
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}", flush=True)
                traceback.print_exc()
    print(f"{len(cells) * len(meshes) - len(failures)} cells in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(t for t, _ in failures))
    print("all cells passed", flush=True)


if __name__ == "__main__":
    main()
