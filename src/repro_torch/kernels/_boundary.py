"""The kernels at a sharded or fake boundary.

  - DTensor inputs reach a kernel through `local_map`: each rank runs the
    kernel on its own heads (attention) or channels (the scan), as plain
    tensors, and the result is a DTensor of the same placements.  The
    model's hints decide the placements before the call; where the query
    heads are sharded over "model" and the KV heads replicated (too few
    to shard), each rank takes the KV heads of its own query heads.
  - Fake or meta inputs (the dry run's FakeTensorMode) launch nothing:
    the wrapper returns outputs of the right shape and reports the
    kernel's FLOPs and bytes to `COUNTS`, which the dry run reads beside
    torch's FlopCounterMode (which cannot see inside a kernel).

The single-card plain-tensor path never comes here: each wrapper checks
for a DTensor (the tensor's exact type, `hints.is_dtensor`) and a fake
tensor (one isinstance test) and otherwise calls its kernel directly.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.distributed.hints import is_dtensor  # noqa: F401

# kernel name -> {"calls", "flops", "bytes"} reported by fake calls
COUNTS: dict = defaultdict(lambda: {"calls": 0, "flops": 0, "bytes": 0})


def reset_counts():
    COUNTS.clear()


def is_fake(x) -> bool:
    return isinstance(x, FakeTensor) or x.device.type == "meta"


def report(name: str, flops: int, nbytes: int):
    c = COUNTS[name]
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _model_dim(mesh):
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def heads_local_map(fn, q, k, v, *, head_dim: int):
    """fn(q, k, v) on each rank's heads: q, k, v DTensors whose placements
    agree on every mesh dim, except that q may shard its heads over
    "model" where k and v are replicated (each rank then takes the KV
    heads its query heads read).  Returns a DTensor placed as q."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    md = _model_dim(mesh)
    kv_slice = False
    for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                         v.placements)):
        if pk != pv:
            raise ValueError(f"k and v placed differently on mesh dim {i}: "
                             f"{pk} vs {pv}")
        if pq == pk:
            continue
        if i == md and pq == Shard(head_dim) and pk == Replicate():
            kv_slice = True
            continue
        raise ValueError(f"q and k/v placed differently on mesh dim {i}: "
                         f"{pq} vs {pk}")
    h, hkv = q.shape[head_dim], k.shape[head_dim]
    ms = mesh.size(md) if md is not None else 1

    def local(ql, kl, vl):
        if kv_slice:
            hl, g = h // ms, h // hkv
            if g % hl:
                raise ValueError(f"{hl} local query heads do not fit the "
                                 f"GQA group of {g}")
            kvh = mesh.get_local_rank(md) * hl // g
            kl = kl.narrow(head_dim, kvh, 1)
            vl = vl.narrow(head_dim, kvh, 1)
        return fn(ql, kl, vl)

    kv_grad = tuple(k.placements)
    if kv_slice:
        # a rank reads only its query heads' KV heads: the KV gradients
        # are partial sums over the model ranks
        from torch.distributed.tensor import Partial
        kv_grad = tuple(Partial() if i == md else p
                        for i, p in enumerate(k.placements))
    return local_map(local, out_placements=list(q.placements),
                     in_placements=(tuple(q.placements),
                                    tuple(k.placements),
                                    tuple(v.placements)),
                     in_grad_placements=(tuple(q.placements), kv_grad,
                                         kv_grad),
                     device_mesh=mesh, redistribute_inputs=False)(q, k, v)


def same_local_map(fn, *xs):
    """fn(*locals) on each rank's shards of DTensors that all share the
    first one's placements (an elementwise-over-channels kernel such as
    the scan); returns a DTensor placed as the first."""
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(xs[0].placements)
    xs = [x if tuple(x.placements) == pl else
          x.redistribute(x.device_mesh, pl) for x in xs]
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl,) * len(xs),
                     device_mesh=xs[0].device_mesh,
                     redistribute_inputs=False)(*xs)


def fake_like(t, shape, dtype=None):
    """An uninitialised fake output of `shape` beside the fake input t."""
    return torch.empty(shape, dtype=dtype or t.dtype, device=t.device)
