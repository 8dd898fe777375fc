"""Collective byte accounting of an eager run: the port's counterpart of
the reference's post-SPMD HLO analysis (`repro.analysis.hlo`).

`CollectiveCounter` is a TorchDispatchMode: every `c10d` or
`c10d_functional` collective dispatched inside it (DTensor's
redistributions, the DiLoCo hop's all-gathers, a fake process group's
hallucinated ones) is recorded with its result's bytes per dtype.  An op
on DTensors is handed back to DTensor first (NotImplemented), so the
collectives DTensor issues inside an op (an FSDP weight's gather in a
matmul) are seen as they run.  Counts
and bytes are per rank: the program a rank runs is the per-device program
the reference's HLO describes.

`collective_bytes()` returns the reference's schema: per op kind
(all-reduce, all-gather, reduce-scatter, all-to-all,
collective-permute) `bytes`, `counts` and `bytes_by_dtype`, plus
`wire_bytes` with the same WIRE_FACTOR (ring algorithms, N participants:
an all-reduce moves ~2x its buffer per device, the others ~1x).  Eager
mode executes every collective it counts, a loop's included, so the
loop-aware total equals the plain one and `unknown_loops` is always
empty.  Host callbacks (the reference's `host_callbacks`) go with the
host-sync lint (ROADMAP A7).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# the reference's HLO dtype names
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# op name -> (kind, which argument holds the result: "out" for the op's
# return value, or the index of an in-place output argument)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _classify(func):
    """(kind, result selector) of a collective op, or None."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns == "c10d" and name in _C10D:
        return _C10D[name]
    if ns in ("_c10d_functional", "c10d_functional") and \
            name in _FUNCTIONAL:
        return _FUNCTIONAL[name], "out"
    return None


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched inside it: `records` is a list
    of (kind, {dtype name: bytes}) in dispatch order."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        hit = _classify(func)
        if hit is not None:
            kind, which = hit
            ts = _tensors(out if which == "out" else args[which])
            by = defaultdict(int)
            for t in ts:
                by[DTYPE_NAMES.get(t.dtype, str(t.dtype))] += \
                    t.numel() * t.element_size()
            self.records.append((kind, dict(by)))
        return out

    def collective_bytes(self) -> dict:
        return collective_bytes(self.records)


def collective_bytes(records) -> dict:
    """The reference's schema from (kind, {dtype: bytes}) records: per
    kind `bytes`, `counts`, `bytes_by_dtype`, and `wire_bytes`."""
    out = defaultdict(int)
    counts = defaultdict(int)
    by_dtype = defaultdict(lambda: defaultdict(int))
    for kind, by in records:
        counts[kind] += 1
        for dt, b in by.items():
            out[kind] += b
            by_dtype[kind][dt] += b
    return {"bytes": dict(out), "counts": dict(counts),
            "bytes_by_dtype": {k: dict(v) for k, v in by_dtype.items()},
            "wire_bytes": sum(WIRE_FACTOR[k] * v for k, v in out.items())}


def collective_bytes_loop_aware(records) -> dict:
    """The reference's loop-aware schema.  Eager mode counts every
    collective a loop executes, so this is the plain total and
    `unknown_loops` is empty."""
    plain = collective_bytes(records)
    return {"bytes": plain["bytes"], "unknown_loops": [],
            "wire_bytes": plain["wire_bytes"]}
