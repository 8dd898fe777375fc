"""Activation sharding hints, resolved against the ambient mesh.

Models annotate their activations with logical axes, as the reference's
do:

    x = shard_hint(x, ("batch", None, "model"))

"batch" resolves to whichever of ("pod", "data") the mesh has, "fsdp" to
"data"; an axis that does not divide its dim is dropped (a 12-head arch
on a 16-way model axis, batch-1 decode).  On a plain tensor the hint is a
no-op, so models never need a mesh.  On a DTensor it redistributes to the
resolved placements: that is where DTensor's gathers and reduce-scatters
happen, at the places the reference's `with_sharding_constraint`s put
them.

The ambient mesh (`on_mesh`) is what the sharded builders set around a
step; `mesh_axis_size` reads it, as the reference reads jax's abstract
mesh.
"""
from __future__ import annotations

import contextlib
import math

import torch

BATCH_AXES = ("pod", "data")

_MESHES: list = []


@contextlib.contextmanager
def on_mesh(mesh):
    """`mesh` ambient inside the block, and plain tensors that meet
    DTensors taken as replicated (DTensor's implicit replication, restored
    on exit: torch's own context manager turns it off on exit, which a
    nested block would do to its caller)."""
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()
        torch._C._set_dtensor_allow_implicit_replication(prev)


def current_mesh():
    return _MESHES[-1] if _MESHES else None


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axis_size(name: str):
    """Size of an axis of the ambient mesh, or None."""
    mesh = current_mesh()
    return None if mesh is None else _sizes(mesh).get(name)


def resolve(spec, shape, sizes: dict) -> tuple:
    """Logical spec -> a spec of mesh axes, the reference's resolution
    and drop rule."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax == "batch":
            cand = tuple(a for a in BATCH_AXES if a in sizes) or None
        elif ax == "fsdp":
            cand = ("data",) if "data" in sizes else None
        elif isinstance(ax, str):
            cand = (ax,) if ax in sizes else None
        elif isinstance(ax, tuple):
            cand = tuple(a for a in ax if a in sizes) or None
        else:
            cand = None
        if cand is not None:
            n = math.prod(sizes[a] for a in cand)
            if n == 0 or dim % n != 0:
                cand = None
        out.append(cand if cand is None or len(cand) > 1 else cand[0])
    return tuple(out) + (None,) * (len(shape) - len(out))


def is_dtensor(x) -> bool:
    """x is a DTensor.  A plain tensor is answered by its exact type, with
    no import: `torch.distributed.tensor` takes about a second to import,
    and the single-card path, which never meets a DTensor, asks this at
    every hint site and kernel call."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gather_fsdp(w, spec):
    """A weight at its compute placement: the spec with its "fsdp" dim
    gathered (ZeRO-3's per-layer all-gather; the backward of the gather
    reduce-scatters the gradient, so no cotangent constraint here), its
    "model" dim still sharded.  On a plain tensor a no-op."""
    if not is_dtensor(w):
        return w
    want = _placements(w, tuple(None if a == "fsdp" else a for a in spec))
    return w if want == tuple(w.placements) else \
        w.redistribute(w.device_mesh, want)


def _placements(x, spec):
    from repro_torch.distributed.sharding import placements_for
    mesh = x.device_mesh
    return tuple(placements_for(resolve(spec, tuple(x.shape), _sizes(mesh)),
                                x.shape, mesh))


class _Constrain(torch.autograd.Function):
    """x placed at `want`, and its gradient placed at `want` too before it
    goes back at x's own placements: the constraint holds for the
    cotangent, as jax's sharding constraint transposes to the same
    constraint.  Without it a partial sum from a
    row-parallel backward (d hnb = dq @ wq^T) travels on unreduced, and
    DTensor resolves it later by gathering a weight instead."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate
        ctx.want = want
        # the gradient goes back at x's placements, a partial sum's as
        # replicated (as DTensor's own redistribute does)
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.want)
        return g.redistribute(g.device_mesh, ctx.back), None


def shard_hint(x, spec):
    """Place a DTensor (and its gradient) at the placements of the logical
    `spec`; a plain tensor passes through."""
    if not is_dtensor(x):
        return x
    want = _placements(x, spec)
    if x.requires_grad:
        return _Constrain.apply(x, want)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(t, n: int, hd: int, ax):
    """(B, S, n * hd) -> (B, S, n, hd), its heads placed on `ax` ("model"
    or None).  A DTensor is placed before the split, which cannot split a
    dim sharded over more ranks than it has heads; a plain tensor is only
    reshaped."""
    b, s, _ = t.shape
    t = shard_hint(t, ("batch", None, ax))
    return shard_hint(t.reshape(b, s, n, hd), ("batch", None, ax, None))


def merge_heads(t, ax):
    """(B, S, n, hd) -> (B, S, n * hd), placed on `ax` before and after the
    merge, so that the gradient reaches the merge placed as well (a
    column-parallel product's gradient, sharded on the merged dim, cannot
    be split back into heads that do not divide the axis)."""
    b, s, n, hd = t.shape
    t = shard_hint(t, ("batch", None, ax, None))
    return shard_hint(t.reshape(b, s, n * hd), ("batch", None, ax))


def heads_axis(n: int):
    """"model" where `n` heads divide the ambient mesh's model axis, else
    None (replicated there)."""
    ms = mesh_axis_size("model")
    return "model" if ms is not None and n % ms == 0 else None


def write_rows(cache, rows, cols, val):
    """cache[rows, cols] = val, in place.  A DTensor cache is written
    shard by shard: each rank writes its own rows (val placed as the
    cache, `rows` indexing the rank's rows, `cols` the same on every
    rank).  A cache whose length (dim 1) is sharded over "model" is
    written only by the rank that holds the position (`_write_slice`)."""
    if not is_dtensor(cache):
        cache[rows, cols] = val.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    names = mesh.mesh_dim_names or ()
    md = names.index("model") if "model" in names else None
    if md is not None and cache.placements[md] == Shard(1):
        want = tuple(Replicate() if i == md else p
                     for i, p in enumerate(cache.placements))
        val = val.redistribute(mesh, want)
        local = cache.to_local()
        _write_slice(local, cols, val.to_local(),
                     mesh.get_local_rank(md) * local.shape[1])
        return
    val = val.redistribute(cache.device_mesh, cache.placements)
    local, v = cache.to_local(), val.to_local()
    if isinstance(rows, slice):
        local[rows, cols] = v.to(local.dtype)
        return
    local_rows = torch.arange(local.shape[0], device=local.device)
    local_rows = local_rows.reshape((-1,) + (1,) * (rows.dim() - 1))
    local[local_rows, cols] = v.to(local.dtype)


def _write_slice(local, cols, v, start: int):
    """Rows' new positions `cols` (B, s), contiguous in each row, written
    into a rank's slice `local` (B, m, ...) of positions [start, start +
    m); a position outside the slice writes nothing.  No host read of
    `cols`: one new position per row (decode) is written at its index
    clamped into the slice under a mask (a masked-out row rewrites its
    own value); several take a `where` over the slice, each position
    gathering the value it receives, if any."""
    b, m = local.shape[0], local.shape[1]
    rows = torch.arange(b, device=local.device)
    v = v.to(local.dtype)
    if cols.shape[0] != b:
        # a scalar offset expanded over the global rows: the same columns
        # for every row
        cols = cols[:1].expand(b, cols.shape[1])
    if cols.shape[1] == 1:
        idx = cols[:, 0] - start
        mine = (idx >= 0) & (idx < m)
        idx = idx.clamp(0, m - 1)
        keep = mine.reshape((b,) + (1,) * (v.dim() - 2))
        local[rows, idx] = torch.where(keep, v[:, 0], local[rows, idx])
        return
    src = torch.arange(start, start + m, device=local.device)[None] \
        - cols[:, :1]                                   # (B, m)
    mine = (src >= 0) & (src < cols.shape[1])
    got = v.gather(1, src.clamp(0, cols.shape[1] - 1).reshape(
        (b, m) + (1,) * (v.dim() - 2)).expand((b, m) + v.shape[2:]))
    keep = mine.reshape((b, m) + (1,) * (v.dim() - 2))
    local.copy_(torch.where(keep, got, local))


def rows_matmul(x, w):
    """x @ w for activations x (..., d) and a weight w whole on every mesh
    dim (replicated), on each rank's own rows: under `local_map`, so that
    DTensor never flattens x's leading dims (a batch and a sequence both
    sharded flatten to a strided shard, whose propagation reads a value
    on the host under fake tensors).  The weight's gradient is a partial
    sum where x is sharded.  Plain tensors: x @ w."""
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor.experimental import local_map
    return local_map(torch.matmul, out_placements=list(x.placements),
                     in_placements=(tuple(x.placements),
                                    tuple(w.placements)),
                     in_grad_placements=(tuple(x.placements),
                                         weight_grad_placements(w, x)),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=False)(x, w)


def weight_grad_placements(w, rows):
    """The gradient placements of a weight `w` that a `local_map` reads
    beside activations placed as `rows`: where the rows shard a mesh dim
    (the batch) and the weight is replicated there, each rank's gradient
    is a partial sum over that dim's ranks; elsewhere as the weight."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(r, Shard) and p == Replicate()
                 else p for p, r in zip(w.placements, rows.placements))


def embed_rows(table, tokens):
    """table[tokens]: the rows of an embedding table.  On a DTensor table
    the lookup runs under `local_map`, vocab-parallel where the table's
    vocab shards over a "model" axis of more than one rank (each rank
    looks up the ids in its own slice, zero elsewhere, and the partial
    sums are reduced), else on each rank's whole table; the rows come
    out batch-major, replicated on "model"."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    table = gather_fsdp(table, ("model", "fsdp"))
    tokens = shard_hint(tokens, ("batch",) + (None,) * (tokens.dim() - 1))
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    md = names.index("model") if "model" in names else None
    split = md is not None and mesh.size(md) > 1 and \
        table.placements[md] == Shard(0)
    out_pl = [Partial() if (i == md and split) else p
              for i, p in enumerate(tokens.placements)]

    def local(t, ids):
        if not split:
            return t[ids]
        v_loc = t.shape[0]
        v0 = mesh.get_local_rank(md) * v_loc
        mine = (ids >= v0) & (ids < v0 + v_loc)
        rows = t[torch.clamp(ids.long() - v0, 0, v_loc - 1)]
        return rows * mine[..., None].to(rows.dtype)

    out = local_map(local, out_placements=out_pl,
                    in_placements=(tuple(table.placements),
                                   tuple(tokens.placements)),
                    in_grad_placements=(weight_grad_placements(table,
                                                               tokens),
                                        tuple(tokens.placements)),
                    device_mesh=mesh, redistribute_inputs=False)(table,
                                                                 tokens)
    return shard_hint(out, ("batch",) + (None,) * (out.dim() - 1))
