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
an all-reduce moves ~2x its buffer per device, the others ~1x).
`by_site()` splits the same bytes by the line of the port that issued
each collective (and its result's shapes), forward and backward apart.
Eager mode executes every collective it counts, a loop's included, so the
loop-aware total equals the plain one and `unknown_loops` is always
empty.

`HostSyncCounter` stands where the reference counts host callbacks in a
compiled graph (`host_callbacks`, same schema: `count` and `targets`):
every read of a tensor's value on the host inside it, on any device.  A
TorchFunctionMode sees the tensor methods that read a value (`.item()`,
`.cpu()`, `.tolist()`, `.numpy()`, `np.asarray`, `.to("cpu")`, `bool()`,
`float()`, `int()`, printing): on CPU tensors these copy nothing and
never reach the dispatcher, so only this layer sees them there.  A
TorchDispatchMode sees what runs below the methods, on the card too:
`_local_scalar_dense`, `is_nonzero`, device-to-host `_to_copy`/`copy_`,
`equal` and the ops whose output shape depends on the data (`nonzero`,
boolean-mask indexing, `masked_select`, `unique`, `repeat_interleave`
without `output_size`).  One read counts once, at the outermost layer
that saw it.  A DeviceMesh's own rank bookkeeping reads CPU tensors on
every device: host work, not counted.  On the card only reads of tensors
on the card count (a CPU tensor's read waits for nothing).
"""
from __future__ import annotations

import contextlib
import sys
from collections import Counter, defaultdict
from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode
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


class Record(NamedTuple):
    """One collective: its kind, its result's bytes by dtype name, the
    site that issued it (`_site`) and its result tensors' shapes."""
    kind: str
    bytes_by_dtype: dict
    site: str
    shapes: tuple


# modules that place or hand over tensors for their callers: a collective
# issued in one is also named by the first frame outside them
_HELPERS = ("repro_torch.distributed.hints", "repro_torch.kernels._boundary")


def _where(f) -> str:
    path = f.f_code.co_filename.replace("\\", "/")
    path = path.split("/repro_torch/", 1)[-1]
    return f"{path}:{f.f_lineno} {f.f_code.co_name}"


def _site() -> str:
    """The innermost frame of the port (not this module) on the Python
    stack, as "file:line function", with " <- " and the first frame
    outside the placement helpers where the innermost is one of them;
    " [backward]" inside a backward pass (a remat's recompute included).
    A backward op that autograd runs with no frame of the port on the
    stack is "autograd [backward]"."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod != __name__:
            names.append(_where(f))
            if not mod.startswith(_HELPERS):
                break
        f = f.f_back
    if len(names) > 1:
        names = [names[0], names[-1]]
    site = " <- ".join(names) or "autograd"
    if torch._C._current_graph_task_id() != -1:
        site += " [backward]"
    return site


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched inside it: `records` is a list
    of `Record`s in dispatch order."""

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
            self.records.append(Record(kind, dict(by), _site(),
                                       tuple(tuple(t.shape) for t in ts)))
        return out

    def collective_bytes(self) -> dict:
        return collective_bytes(self.records)

    def by_site(self) -> dict:
        return by_site(self.records)


def by_site(records) -> dict:
    """Bytes, counts and wire bytes per (kind, site), largest wire first:
    "<kind> @ <site>" -> {"bytes", "counts", "wire_bytes", "shapes":
    {shape: count}}.  The sites' sums are `collective_bytes`'s totals."""
    sites = {}
    for r in records:
        e = sites.setdefault(f"{r.kind} @ {r.site}", {
            "bytes": 0, "counts": 0, "wire_bytes": 0.0, "shapes": {}})
        b = sum(r.bytes_by_dtype.values())
        e["bytes"] += b
        e["counts"] += 1
        e["wire_bytes"] += WIRE_FACTOR[r.kind] * b
        shape = " ".join("x".join(map(str, s)) for s in r.shapes)
        e["shapes"][shape] = e["shapes"].get(shape, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]["wire_bytes"]))


def collective_bytes(records) -> dict:
    """The reference's schema from `Record`s: per kind `bytes`, `counts`,
    `bytes_by_dtype`, and `wire_bytes`."""
    out = defaultdict(int)
    counts = defaultdict(int)
    by_dtype = defaultdict(lambda: defaultdict(int))
    for kind, by, *_ in records:
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


# --------------------------------------------------------------------------
# host syncs
# --------------------------------------------------------------------------
# tensor methods that read a value to the host
_READ_METHODS = {"item", "tolist", "numpy", "cpu", "__bool__", "__float__",
                 "__int__", "__index__", "__complex__", "__array__",
                 "__repr__", "__str__", "__format__"}
# aten ops that wait for the device (by op name, any overload)
_SYNC_OPS = {"_local_scalar_dense", "is_nonzero", "equal", "nonzero",
             "masked_select", "_unique", "_unique2", "unique_dim",
             "unique_consecutive", "argwhere"}


# modules whose tensor reads are host bookkeeping on every device
_HOST_MODULES = ("torch.distributed.device_mesh",
                 "torch.distributed._mesh_layout")


def _in_host_bookkeeping() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_globals.get("__name__", "").startswith(_HOST_MODULES):
            return True
        f = f.f_back
    return False


def _cpu_target(args, kwargs) -> bool:
    """True for a `.to("cpu")`: a target the code names as the host.  A
    `torch.device` target is the run's own device (`.to(x.device)`), a
    no-op on a CPU run; on the card the dispatch layer sees a real
    device-to-host `_to_copy` whatever named it."""
    return any(isinstance(a, str) and torch.device(a).type == "cpu"
               for a in list(args[1:2]) + [kwargs.get("device")])


def _on_device(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type not in ("cpu",
                                                                  "meta")


def _bool_index(indices) -> bool:
    return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                            torch.uint8)
               for i in indices or ())


def _dispatch_sync(func, args, kwargs) -> str | None:
    """The name of the host sync this aten call is, or None."""
    name = func._schema.name.split("::")[-1]
    if name in _SYNC_OPS:
        return f"aten.{name}"
    if name == "repeat_interleave" and kwargs.get("output_size") is None \
            and func._overloadname in ("Tensor", "self_Tensor"):
        return "aten.repeat_interleave (no output_size)"
    if name in ("index", "index_put", "index_put_") and \
            _bool_index(args[1] if len(args) > 1 else kwargs.get("indices")):
        return f"aten.{name} (boolean mask)"
    if name == "_to_copy" and _on_device(args[0]) and \
            kwargs.get("device") is not None and \
            torch.device(kwargs["device"]).type == "cpu":
        return "aten._to_copy (device to host)"
    if name == "copy_" and len(args) > 1 and _on_device(args[1]) and \
            isinstance(args[0], torch.Tensor) and args[0].device.type == "cpu":
        return "aten.copy_ (device to host)"
    return None


class _SyncFunctions(TorchFunctionMode):
    def __init__(self, owner):
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        read = name in _READ_METHODS or (name == "to" and
                                         _cpu_target(args, kwargs))
        if not read or not self.owner._counts(args):
            return func(*args, **kwargs)
        self.owner.targets[f"Tensor.{name}"] += 1
        self.owner._depth += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.owner._depth -= 1


class _SyncOps(TorchDispatchMode):
    def __init__(self, owner):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            return NotImplemented
        hit = _dispatch_sync(func, args, kwargs)
        if hit is None or not self.owner._counts(args):
            return func(*args, **kwargs)
        self.owner.targets[hit] += 1
        self.owner._depth += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.owner._depth -= 1


class HostSyncCounter:
    """Counts the host syncs of the code run inside it: each read of a
    tensor's value on the host, by what read it (`targets`).  `device`
    is where the run's tensors live.  On the card,
    `torch.cuda.set_sync_debug_mode("warn")` is the second witness
    (`sync_debug_warnings`)."""

    def __init__(self, device="cpu"):
        self.card = torch.device(device).type == "cuda"
        self.targets = Counter()
        self._depth = 0
        self._stack = None

    def _counts(self, args) -> bool:
        """Whether a read of `args` counts: not inside another counted
        read, not DeviceMesh bookkeeping, and on the card a read of a
        tensor on the card."""
        if self._depth:
            return False
        if self.card and not any(_on_device(t) for t in _tensors(args)):
            return False
        return not _in_host_bookkeeping()

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_SyncFunctions(self))
        self._stack.enter_context(_SyncOps(self))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def host_syncs(self) -> dict:
        """The reference's `host_callbacks` schema: count and targets."""
        return {"count": sum(self.targets.values()),
                "targets": dict(self.targets)}


# what `torch.cuda.set_sync_debug_mode("warn")` says of each operation
# that synchronizes (not its one-time notice that the mode is a prototype)
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def sync_debug_warnings():
    """On the card: yields a list that collects the synchronizing
    operations `torch.cuda.set_sync_debug_mode("warn")` reports inside the
    block (an inner `no_host_sync` block raises instead); it is complete
    when the block exits.  Elsewhere: an empty list."""
    import warnings
    found = []
    if not torch.cuda.is_available():
        yield found
        return
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            yield found
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        found.extend(w for w in caught if SYNC_WARNING in str(w.message))

