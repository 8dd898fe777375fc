"""The kernels at a sharded or fake boundary.

  - DTensor inputs reach a kernel through `local_map`: each rank runs the
    kernel on its own heads (attention) or channels (the scan), as plain
    tensors, and the result is a DTensor of the same placements.  The
    model's hints decide the placements before the call; where the query
    heads are sharded over "model" and the KV heads replicated (too few
    to shard), each rank takes the KV heads of its own query heads.
  - Sequence parallelism on "model", the reference's layouts where the
    heads do not divide the axis: `seq_local_map` takes a decode call
    whose KV cache shards its length over "model" (each rank attends
    over its slice at its local length and returns its partial with the
    log-sum-exp; the partials are all-gathered over "model" and merged),
    `query_local_map` a call whose q shards its sequence there against
    whole K/V (each rank runs its query rows at the offset of its first
    row).
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

# kernel name -> {"calls", "flops", "bytes"} reported by fake calls, and
# "flops_by_model_rank" where a call inside a query split reported every
# model rank's count (the ranks' causal work differs by their offsets)
COUNTS: dict = defaultdict(lambda: {"calls": 0, "flops": 0, "bytes": 0})

# the query split of the call running now: each model rank's query
# offset less this rank's (query_local_map sets it around its call)
_SPLIT: list = []
# calls of query_local_map since the last reset, fake or not
SPLITS = {"calls": 0}


def reset_counts():
    COUNTS.clear()
    SPLITS["calls"] = 0


def is_fake(x) -> bool:
    return isinstance(x, FakeTensor) or x.device.type == "meta"


def report(name: str, flops: int, nbytes: int, by_rank=None):
    """A fake call's count; `by_rank` the FLOPs each model rank's call
    would count (inside a query split)."""
    c = COUNTS[name]
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)
    if by_rank is not None:
        acc = c.setdefault("flops_by_model_rank", [0] * len(by_rank))
        for i, f in enumerate(by_rank):
            acc[i] += int(f)


def query_split():
    """Inside `query_local_map`: the model ranks' query offsets less this
    rank's (a fake kernel call counts each rank's work from it); else
    None."""
    return _SPLIT[-1] if _SPLIT else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _model_dim(mesh):
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def length_sharded(x, dim: int) -> bool:
    """x is a DTensor whose dim `dim` (a cache's length, q's sequence) is
    sharded over "model"."""
    from torch.distributed.tensor import Shard
    md = _model_dim(x.device_mesh)
    return md is not None and x.placements[md] == Shard(dim)


def whole_on_model(x):
    """A DTensor gathered whole on "model" (its other placements kept)."""
    from torch.distributed.tensor import Replicate
    md = _model_dim(x.device_mesh)
    want = tuple(Replicate() if i == md else p
                 for i, p in enumerate(x.placements))
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def _agree_but_model(md, *xs):
    """Raise unless the DTensors' placements agree on every mesh dim but
    "model"'s."""
    for i, ps in enumerate(zip(*(x.placements for x in xs))):
        if i != md and len(set(ps)) > 1:
            raise ValueError(f"placements differ on mesh dim {i}: {ps}")


def seq_local_map(partial, merge, q, k_cache, v_cache, kv_len):
    """Decode attention over a cache whose length (dim 1 of (B, M, Hkv,
    dh)) is sharded over "model": q (B, 1, H, dh) or (B, H, dh),
    replicated there.  Rank r holds positions [r m, (r + 1) m) and runs
    `partial(q, k, v, len)` at its local length clamp(kv_len - r m, 0, m)
    (kv_len a scalar, the same on every rank), which gives (out, lse);
    the ranks' (out, lse), f32, are all-gathered over "model" and
    `merge(outs, lses)` combines them.  Returns a DTensor placed as q.
    No host read: the lengths stay tensors where kv_len is one."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    mesh = q.device_mesh
    md = _model_dim(mesh)
    _agree_but_model(md, q, k_cache, v_cache)
    if q.placements[md] != Replicate() or \
            v_cache.placements[md] != k_cache.placements[md]:
        raise ValueError(f"q must be replicated and v placed as k on "
                         f"'model': {q.placements}, {k_cache.placements}, "
                         f"{v_cache.placements}")
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    m, ms = kl.shape[1], mesh.size(md)
    start = mesh.get_local_rank(md) * m
    if torch.is_tensor(kv_len):
        lens = (kv_len - start).clamp(0, m)
    else:
        lens = min(max(int(kv_len) - start, 0), m)
    out, lse = partial(ql, kl, vl, lens)
    dh = out.shape[-1]
    mine = torch.cat([out.float().reshape(lse.shape + (dh,)),
                      lse[..., None]], -1).contiguous()
    every = mine.new_empty((ms * mine.shape[0],) + mine.shape[1:])
    dist.all_gather_into_tensor(every, mine, group=mesh.get_group(md))
    every = every.reshape((ms,) + mine.shape)
    merged = merge(every[..., :dh], every[..., dh]).to(out.dtype)
    return DTensor.from_local(merged.reshape(out.shape), mesh,
                              q.placements, run_check=False)


def query_local_map(fn, q, k, v, *, seq_dim: int):
    """fn(q, k, v, offset) on each rank's query rows: q's sequence (dim
    `seq_dim`) sharded over "model", k and v whole there (replicated).
    Rank r's rows start at position r * S / N, its `offset`; a causal
    kernel call masks at it.  The KV gradients are partial sums over the
    model ranks (each rank's rows read all of K/V).  Returns a DTensor
    placed as q."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    md = _model_dim(mesh)
    _agree_but_model(md, q, k, v)
    if k.placements[md] != Replicate() or v.placements[md] != Replicate():
        raise ValueError(f"a query split needs k and v whole on 'model': "
                         f"{k.placements}, {v.placements}")
    ms = mesh.size(md)

    def local(ql, kl, vl):
        r, n = mesh.get_local_rank(md), ql.shape[seq_dim]
        SPLITS["calls"] += 1
        _SPLIT.append([(j - r) * n for j in range(ms)])
        try:
            return fn(ql, kl, vl, r * n)
        finally:
            _SPLIT.pop()

    kv_grad = tuple(Partial() if i == md else p
                    for i, p in enumerate(k.placements))
    return local_map(local, out_placements=list(q.placements),
                     in_placements=(tuple(q.placements),
                                    tuple(k.placements),
                                    tuple(v.placements)),
                     in_grad_placements=(tuple(q.placements), kv_grad,
                                         kv_grad),
                     device_mesh=mesh, redistribute_inputs=False)(q, k, v)


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
