"""Delta compression for the ISL (pod-axis) hop, in PyTorch.

DiLoCo already cuts pod-axis traffic by the inner-step factor H; these
compressors cut the remaining outer-sync bytes further:

  - int8: per-block absmax quantization (4x vs f32).  With error feedback
    the quantization residual re-enters the next outer delta, so the
    scheme stays unbiased over time.
  - top-k: magnitude sparsification (values + int32 indices), also with
    error feedback.

Two layouts share the same numerics:

  - the legacy single-lane layout (`int8_compress`/`topk_compress`):
    flatten the whole leaf, pad at the end;
  - the wire format (`WireFormat` + `*_wire_*`): the leaf is split into
    its tiles (one lane per device shard) and every lane is padded inside
    the shard, so no quantization block straddles a shard boundary.  A
    single-lane layout is bitwise the legacy one.

Every function here is plain tensor code on whatever device its inputs
live on, bitwise the reference's on the same inputs: the int8 scale is
`absmax / 127` and the quantizer divides by it (no reciprocal multiply),
rounding half to even as `jnp.round` does; top-k orders equal magnitudes
lower index first, as `jax.lax.top_k` does (`torch.topk` promises no
order among ties, so the selection is a stable sort).  A wire format
with a `mesh` (from `wire_format_for`) runs as the hop over the mesh's
"pod" process group (`train/diloco.py::_wire_shard_hop`); without one,
the same layout runs as the pod-local simulation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def _stable_topk_indices(a, k: int):
    """Indices of the k largest entries along the last axis, larger first
    and equal values lower index first."""
    return torch.sort(a, dim=-1, descending=True, stable=True).indices[
        ..., :k]


# --------------------------------------------------------------------------
# int8 absmax
# --------------------------------------------------------------------------
def int8_compress(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % 256
    rows = F.pad(flat, (0, pad)).reshape(-1, 256)
    scale = rows.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(rows / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float(), "shape": tuple(x.shape),
            "n": flat.shape[0]}


def int8_decompress(c):
    rows = c["q"].float() * c["scale"]
    return rows.reshape(-1)[:c["n"]].reshape(c["shape"])


def int8_bytes(c) -> int:
    return int(c["q"].numel() + c["scale"].numel() * 4)


# --------------------------------------------------------------------------
# top-k sparsification
# --------------------------------------------------------------------------
def topk_compress(x, frac: float = 0.01):
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = _stable_topk_indices(flat.abs(), k)
    return {"values": flat[idx], "indices": idx.to(torch.int32),
            "shape": tuple(x.shape), "n": flat.shape[0]}


def topk_decompress(c):
    flat = torch.zeros((c["n"],), dtype=c["values"].dtype,
                       device=c["values"].device)
    flat[c["indices"].long()] = c["values"]
    return flat.reshape(c["shape"])


def topk_bytes(c) -> int:
    """Wire bytes of a top-k payload: values at their own dtype width plus
    the s32 indices."""
    return int(c["values"].numel() * c["values"].element_size()
               + c["indices"].numel() * c["indices"].element_size())


# --------------------------------------------------------------------------
# wire format: shard-aligned lanes, padded inside the shard
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class WireLeaf:
    """Per-leaf wire layout: `counts[i]` shards along dim i (the tile
    grid), `spec` the per-dim mesh axis names the counts came from.
    counts of all ones == the legacy single-lane layout."""
    counts: tuple
    spec: tuple = ()


@dataclass(frozen=True)
class WireFormat:
    """The outer-sync wire contract: method + per-leaf lane layout (a tree
    of `WireLeaf`s matching the params).

    With `mesh` (a DeviceMesh with a "pod" axis) the hop runs over the
    mesh: each rank quantizes its own tile and the compressed payload is
    all-gathered over the "pod" group.  With mesh=None the same layout
    runs as the pod-local simulation, bitwise the same result."""
    method: str                 # "int8" | "topk"
    layout: Any
    n_pods: int
    mesh: Any = None
    block: int = 256
    topk_frac: float = 0.01

    def simulated(self) -> "WireFormat":
        return replace(self, mesh=None)


def is_wire_leaf(x) -> bool:
    return isinstance(x, WireLeaf)


def wire_format_for(params, pspecs, mesh, n_pods: int, *, method: str,
                    block: int = 256, topk_frac: float = 0.01) -> WireFormat:
    """The shard-aligned WireFormat of the param specs on `mesh` (a
    DeviceMesh, or anything `sharding.axis_sizes` reads).

    Lane counts come from the sanitized specs (axes that do not divide
    are dropped, as the state's placements drop them), so the lanes are
    exactly the tiles each rank holds.  If the mesh cannot host the pod
    axis (no "pod" axis, or n_pods not a multiple of its size), or is not
    a DeviceMesh, the format is the simulated hop (mesh=None) with the
    same layout.  `params`: tensors or `sharding.SDS` leaves."""
    from repro_torch.distributed.sharding import axis_sizes, sanitize_specs
    specs = sanitize_specs(pspecs, params, mesh)
    sizes = axis_sizes(mesh)

    def leaf(spec, x):
        counts = []
        for ax in spec:
            if ax is None:
                counts.append(1)
                continue
            axs = ax if isinstance(ax, tuple) else (ax,)
            counts.append(math.prod(sizes[a] for a in axs))
        return WireLeaf(counts=tuple(counts), spec=tuple(spec))

    layout = tree_map(lambda s, x: leaf(s, x), specs, params)
    pod_ok = ("pod" in sizes and n_pods % sizes["pod"] == 0
              and hasattr(mesh, "mesh_dim_names"))
    return WireFormat(method=method, layout=layout, n_pods=n_pods,
                      mesh=mesh if pod_ok else None, block=block,
                      topk_frac=topk_frac)


def tiles_of(x, counts):
    """(S, m) lane view of x matching the tile grid: dim i splits into
    counts[i] contiguous blocks, shard indices move to the front — lane j
    holds exactly the elements shard j holds."""
    if x.dim() == 0:
        return x.reshape(1, 1)
    shape2, front, back = [], [], []
    for i, (dim, s) in enumerate(zip(x.shape, counts)):
        shape2 += [s, dim // s]
        front.append(2 * i)
        back.append(2 * i + 1)
    t = x.reshape(shape2).permute(front + back)
    return t.reshape(math.prod(counts), -1)


def untile(t, counts, shape):
    """Inverse of tiles_of."""
    if len(shape) == 0:
        return t.reshape(())
    locals_ = [d // s for d, s in zip(shape, counts)]
    t = t.reshape(tuple(counts) + tuple(locals_))
    perm = []
    for i in range(len(shape)):
        perm += [i, len(shape) + i]
    return t.permute(perm).reshape(tuple(shape))


def int8_wire_compress(t, block: int = 256):
    """Quantize (S, m) lanes, padded inside each lane to a block multiple.
    Returns (q (S, R, block) int8, scale (S, R, 1) f32)."""
    s_lanes, m = t.shape
    rows = -(-m // block)
    pad = rows * block - m
    r = F.pad(t, (0, pad)).reshape(s_lanes, rows, block)
    scale = r.abs().amax(dim=2, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(r / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def int8_wire_decompress(q, scale, m: int):
    r = q.float() * scale
    return r.reshape(q.shape[0], -1)[:, :m]


def topk_wire_k(m: int, frac: float) -> int:
    return 0 if m == 0 else max(1, int(m * frac))


def topk_wire_compress(t, frac: float = 0.01):
    """Per-lane top-k over (S, m) lanes, lane-local indices.  Returns
    (values (S, k), indices (S, k) s32)."""
    s_lanes, m = t.shape
    k = topk_wire_k(m, frac)
    if k == 0:
        return (t.new_zeros((s_lanes, 0)),
                torch.zeros((s_lanes, 0), dtype=torch.int32,
                            device=t.device))
    idx = _stable_topk_indices(t.abs(), k)
    vals = torch.gather(t, 1, idx)
    return vals, idx.to(torch.int32)


def topk_wire_decompress(vals, idx, m: int):
    s_lanes = vals.shape[0]
    flat = vals.new_zeros((s_lanes, m))
    if vals.shape[1] == 0:
        return flat
    lanes = torch.arange(s_lanes, device=vals.device)[:, None]
    flat[lanes, idx.long()] = vals
    return flat


def ef_wire_roundtrip(x, ef, counts, method: str = "int8",
                      block: int = 256, topk_frac: float = 0.01):
    """One error-feedback hop for a single leaf in the wire layout.
    Returns (payload, sent, new_residual); with counts all ones this is
    bitwise the legacy `ef_roundtrip`."""
    target = x.float() + ef
    t = tiles_of(target, counts)
    m = t.shape[1]
    if method == "int8":
        q, scale = int8_wire_compress(t, block)
        sent_t = int8_wire_decompress(q, scale, m)
        payload = {"q": q, "scale": scale, "shape": tuple(target.shape),
                   "n": m}
    elif method == "topk":
        vals, idx = topk_wire_compress(t, topk_frac)
        sent_t = topk_wire_decompress(vals, idx, m)
        payload = {"values": vals, "indices": idx,
                   "shape": tuple(target.shape), "n": m}
    else:
        raise ValueError(f"unknown wire method {method!r}")
    sent = untile(sent_t, counts, tuple(target.shape))
    return payload, sent, target - sent


def wire_leaf_bytes(shape, counts, method: str | None, block: int = 256,
                    topk_frac: float = 0.01) -> int:
    """Static per-pod wire bytes for one leaf in the lane layout, per-lane
    padding included."""
    n = math.prod(shape) if shape else 1
    s_lanes = math.prod(counts) if counts else 1
    m = n // s_lanes
    if method == "int8":
        rows = -(-m // block)
        return s_lanes * rows * (block + 4)      # s8 payload + f32 scales
    if method == "topk":
        return s_lanes * topk_wire_k(m, topk_frac) * 8   # f32 + s32 pairs
    return 4 * n


def wire_tree_bytes(params, fmt: WireFormat) -> int:
    total = 0
    for x, lay in zip(tree_leaves(params), tree_leaves(fmt.layout)):
        total += wire_leaf_bytes(tuple(x.shape), lay.counts, fmt.method,
                                 fmt.block, fmt.topk_frac)
    return total


# --------------------------------------------------------------------------
# error feedback wrapper (per leaf, over trees)
# --------------------------------------------------------------------------
def ef_init(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def ef_roundtrip(x, ef, method: str = "int8", **kw):
    """One error-feedback hop for a single leaf.  Returns (compressed,
    sent, new_residual) with sent + new_residual == x + ef exactly."""
    comp_fn = {"int8": int8_compress,
               "topk": lambda v: topk_compress(v, **kw)}[method]
    dec_fn = {"int8": int8_decompress, "topk": topk_decompress}[method]
    target = x.float() + ef
    c = comp_fn(target)
    sent = dec_fn(c)
    return c, sent, target - sent


def ef_compress_tree(tree, ef, method: str = "int8", **kw):
    """Returns (compressed_tree, new_ef, wire_bytes)."""
    size_fn = {"int8": int8_bytes, "topk": topk_bytes}[method]
    compressed, new_ef, total = [], [], 0
    for x, e in zip(tree_leaves(tree), tree_leaves(ef)):
        c, _, resid = ef_roundtrip(x, e, method, **kw)
        compressed.append(c)
        new_ef.append(resid)
        total += size_fn(c)
    return (tree_unflatten(tree, compressed), tree_unflatten(tree, new_ef),
            total)


def decompress_tree(ctree, method: str = "int8"):
    dec_fn = {"int8": int8_decompress, "topk": topk_decompress}[method]
    if "shape" in ctree:                     # a payload is a leaf
        return dec_fn(ctree)
    return {k: decompress_tree(v, method) for k, v in ctree.items()}


def tree_bytes_f32(tree) -> int:
    return sum(4 * x.numel() for x in tree_leaves(tree))
