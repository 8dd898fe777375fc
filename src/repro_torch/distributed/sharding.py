"""Partition-spec builders: how every architecture shards on the production
mesh ("pod", "data", "model"), and their DTensor placements.

Strategy (the reference's `repro.distributed.sharding`):
  - "model": tensor parallel — attention heads / FFN hidden / experts /
    vocab.  Column-parallel in-projections, row-parallel out-projections.
  - "data" (+ "pod"): batch data parallelism; with fsdp=True the weights'
    other dimension also shards over "data" (ZeRO-3: parameters gathered
    per layer, gradients reduce-scattered).
  - "pod": pure DP over satellites; DiLoCo puts the pod replicas there.
  - The batch axis of activations shards over ("pod", "data").

A spec is a tuple with one entry per tensor dim: None, a mesh-axis name,
or a tuple of names (sharded over their product, the first name the
outermost).  A spec tree has the structure of the value tree it
describes; where a value is a tuple of tensors (a recurrent cache's
carries), its spec is a tuple of specs.  `sanitize_specs` drops an axis
that does not divide its dim (the reference's rule), and
`placements_for` turns a sanitized spec into DTensor placements: a dim
sharded over ("pod", "data") becomes Shard(dim) on both mesh dims, which
DTensor splits in mesh-dim order, pod-major, as the reference's
PartitionSpec does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train.tree import tree_map


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


# --------------------------------------------------------------------------
# spec trees <-> value trees
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SDS:
    """A tensor's global shape and dtype, with nothing allocated (the
    counterpart of jax.ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def zip_specs(spec_tree, value_tree, fn):
    """fn(spec, value) over the leaves of `value_tree` (tensors or SDS),
    walking dicts and tuples: a tuple of tensors takes a tuple of specs
    of its length."""
    if isinstance(value_tree, dict):
        return {k: zip_specs(spec_tree[k], v, fn)
                for k, v in value_tree.items()}
    if isinstance(value_tree, (tuple, list)):
        if len(spec_tree) != len(value_tree):
            raise ValueError(f"{len(value_tree)} tensors, "
                             f"{len(spec_tree)} specs")
        return type(value_tree)(zip_specs(s, v, fn)
                                for s, v in zip(spec_tree, value_tree))
    return fn(spec_tree, value_tree)


def spec_leaves(spec_tree, value_tree) -> list:
    """The specs of `value_tree`'s tensors, in its leaf order."""
    out = []
    zip_specs(spec_tree, value_tree, lambda s, v: out.append(s))
    return out


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size, for a DeviceMesh, a dict, or anything with
    `axis_names` and `devices` (the reference's Mesh, or a stand-in)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def sanitize_spec(spec, shape, sizes: dict) -> tuple:
    """One spec, padded to the tensor's rank, with every axis that the
    mesh lacks or whose size does not divide its dim dropped, and a
    one-axis tuple written as that axis."""
    spec = tuple(spec or ())
    parts = spec + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes for a in axs):
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in axs)
        # a one-axis tuple is that axis (as a PartitionSpec normalises it)
        out.append((axs[0] if len(axs) == 1 else axs) if dim % n == 0
                   else None)
    return tuple(out)


def sanitize_specs(spec_tree, value_tree, mesh):
    """Drop sharding on axes whose size does not divide (batch-1 cells,
    12-head archs on a 16-way model axis, 2 DiLoCo pods on a 1-pod
    mesh).  Returns a spec tree of `value_tree`'s structure."""
    sizes = axis_sizes(mesh)
    return zip_specs(spec_tree, value_tree,
                     lambda s, v: sanitize_spec(s, tuple(v.shape), sizes))


def placements_for(spec, shape, mesh):
    """A spec (sanitized here against `shape`) -> DTensor placements, one
    per mesh dim.  A tuple of axes must follow the mesh's dim order (the
    outer axis first), as every spec here does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    spec = sanitize_spec(spec, tuple(shape), axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"axes {axs} of dim {dim} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_shape(shape, placements, mesh) -> tuple:
    """The shape of this rank's shard (the specs here shard evenly)."""
    from torch.distributed.tensor import Shard
    shape = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
    return tuple(shape)


def slice_as(x, mesh, placements):
    """A global tensor (the same on every rank) -> a DTensor of these
    Shard / Replicate placements, each rank keeping its own slice (no
    communication).  Mesh dims shard in order, the outer first."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import Replicate, Shard
    local = x
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot slice into placement {p}")
    return DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def distribute(tree, spec_tree, mesh):
    """Global tensors (the same on every rank) -> DTensors placed by the
    specs (`slice_as`)."""
    return zip_specs(spec_tree, tree, lambda spec, x: slice_as(
        x, mesh, placements_for(spec, x.shape, mesh)))


def make_local(shapes, spec_tree, mesh, make):
    """DTensors of the global shapes in `shapes` (a tree of SDS) whose
    local shards come from make(local_shape, dtype): the dry run's way to
    build a state without the global tensors."""
    def one(spec, sd):
        shape, dtype = tuple(sd.shape), sd.dtype
        pl = placements_for(spec, shape, mesh)
        return dtensor_of(make(local_shape(shape, pl, mesh), dtype), mesh,
                          pl, shape)
    return zip_specs(spec_tree, shapes, one)


def dtensor_of(local, mesh, placements, shape):
    """A DTensor of global `shape` (contiguous) from this rank's shard,
    with no communication and no check that the ranks agree."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def gather_full(tree):
    """DTensors -> full plain tensors (an all-gather of each); plain
    tensors pass through."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def prepend_axis(spec_tree, axis=None):
    """Prefix every spec with one leading dim (the DiLoCo pod-replica
    axis, a fused block's step axis); axis None keeps it unsharded."""
    return tree_map(lambda s: (axis,) + tuple(s or ()), spec_tree)


# --------------------------------------------------------------------------
# the reference's spec rules, per family
# --------------------------------------------------------------------------
def _transformer_specs(cfg, fsdp: bool, dp):
    d = dp if fsdp else None   # the FSDP shard axis
    L = lambda *rest: (None,) + rest                        # noqa: E731
    layers = {
        "attn_norm": L(None),
        "wq": L(d, "model"),
        "wk": L(d, "model"),
        "wv": L(d, "model"),
        "wo": L("model", d),
    }
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = L(None)
    if cfg.qkv_bias:
        layers["bq"] = L("model")
        layers["bk"] = L("model")
        layers["bv"] = L("model")
    if not cfg.parallel_block:
        layers["mlp_norm"] = L(None)
        if cfg.norm == "layernorm":
            layers["mlp_norm_bias"] = L(None)
    if cfg.is_moe:
        layers["router"] = L(d, None)
        layers["moe_wi_gate"] = L("model", d, None)   # experts on "model"
        layers["moe_wi_up"] = L("model", d, None)
        layers["moe_wo"] = L("model", None, d)
    elif cfg.mlp_act == "gelu":
        layers["wi"] = L(d, "model")
        layers["bi"] = L("model")
        layers["wo_mlp"] = L("model", d)
        layers["bo"] = L(None)
    else:
        layers["wi_gate"] = L(d, "model")
        layers["wi_up"] = L(d, "model")
        layers["wo_mlp"] = L("model", d)

    embed = ((None, "model", d) if cfg.n_codebooks > 1 else ("model", d))
    specs = {"embed": embed, "layers": layers, "final_norm": (None,)}
    if cfg.norm == "layernorm":
        specs["final_norm_bias"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((None, d, "model") if cfg.n_codebooks > 1
                            else (d, "model"))
    return specs


def _xlstm_specs(cfg, fsdp: bool, dp):
    d = dp if fsdp else None
    L = lambda *rest: (None,) + rest                        # noqa: E731
    # n_heads=4 < the model axis, so the head-structured recurrent weights
    # (r_gates) stay replicated; channel-structured projections shard
    slstm = {
        "norm": L(None), "w_gates": L(d, "model"),
        "r_gates": L(None, None, None),
        "b_gates": L("model"), "w_out": L(d, "model"),
    }
    mlstm = {
        "norm": L(None), "w_up": L(d, "model"), "w_gate": L(d, "model"),
        "w_q": L(d, "model"), "w_k": L(d, "model"), "w_v": L(d, "model"),
        "w_if": L(d, None), "b_if": L(None), "skip_norm": L(None),
        "w_down": L("model", d),
    }
    return {"embed": ("model", d), "slstm": slstm, "mlstm": mlstm,
            "final_norm": (None,)}


def _rglru_specs(cfg, fsdp: bool, dp):
    d = dp if fsdp else None
    L = lambda *rest: (None,) + rest                        # noqa: E731

    def rec():
        return {
            "norm": L(None), "w_x": L(d, "model"), "w_gate": L(d, "model"),
            "conv": L(None, "model"), "w_ri": L(d, "model"),
            "b_ri": L("model"), "lam": L("model"), "w_out": L("model", d),
            "mlp_norm": L(None), "wi_gate": L(d, "model"),
            "wi_up": L(d, "model"), "wo_mlp": L("model", d),
        }

    def attn():
        return {
            "norm": L(None), "wq": L(d, "model"), "wk": L(d, None),
            "wv": L(d, None), "wo": L("model", d),
            "mlp_norm": L(None), "wi_gate": L(d, "model"),
            "wi_up": L(d, "model"), "wo_mlp": L("model", d),
        }

    specs = {"embed": ("model", d), "rec_a": rec(), "rec_b": rec(),
             "attn": attn(), "final_norm": (None,)}
    if cfg.n_tail_rec:
        specs["tail"] = rec()
    return specs


def param_specs(cfg, *, fsdp: bool = True, multi_pod: bool = False,
                fsdp_axis: str = "data"):
    """Spec tree matching the arch's init_params structure.  The RG-LRU
    is elementwise over channels, so sharding w_ri's channel dim over
    "model" keeps the whole recurrence collective-free."""
    from repro_torch.models.rglru import RGLRUConfig
    from repro_torch.models.xlstm import XLSTMConfig
    if isinstance(cfg, XLSTMConfig):
        return _xlstm_specs(cfg, fsdp, fsdp_axis)
    if isinstance(cfg, RGLRUConfig):
        return _rglru_specs(cfg, fsdp, fsdp_axis)
    return _transformer_specs(cfg, fsdp, fsdp_axis)


def batch_specs(kind: str, multi_pod: bool = False):
    b = (batch_axes(multi_pod),)
    specs = {"tokens": b, "labels": b}
    if kind == "vlm":
        specs["positions"] = (None, batch_axes(multi_pod))
    return specs


def cache_specs(cfg, multi_pod: bool = False):
    """KV-cache / serving-state specs: batch over the dp axes, channels
    over "model" where divisible."""
    from repro_torch.models.rglru import RGLRUConfig
    from repro_torch.models.xlstm import XLSTMConfig
    b = batch_axes(multi_pod)
    if isinstance(cfg, XLSTMConfig):
        s = (None, b)
        return {"slstm": (s, s, s, s), "mlstm": (s, s, s), "pos": ()}
    if isinstance(cfg, RGLRUConfig):
        rec = ((None, b, "model"), (None, b, None, "model"))
        out = {"rec_a": rec, "rec_b": rec,
               "attn": ((None, b), (None, b)), "pos": ()}
        if cfg.n_tail_rec:
            out["tail"] = rec
        return out
    # transformer: (L, B, M, Hkv, hd)
    return {"k": (None, b), "v": (None, b), "pos": ()}


def opt_state_specs(pspecs):
    """Adam m/v shard exactly like params (ZeRO)."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def train_state_specs(pspecs):
    """Spec tree matching train/loop.py's {params, opt, step} state."""
    return {"params": pspecs, "opt": opt_state_specs(pspecs), "step": ()}


def diloco_specs(pspecs, *, compress: bool = False, screen: bool = False):
    """Spec tree matching train/diloco.py's diloco_init structure: global
    params and momentum shard like one replica; the per-pod replicas
    carry a leading axis sharded over "pod"."""
    pod = lambda t: prepend_axis(t, "pod")                  # noqa: E731
    specs = {
        "global_params": pspecs,
        "outer_m": pspecs,
        "pod_params": pod(pspecs),
        "pod_opt": pod(opt_state_specs(pspecs)),
        "step": (),
    }
    if compress:
        specs["pod_ef"] = pod(pspecs)
    if screen:
        specs["screen"] = {"loss": ("pod", None), "gnorm": ("pod", None),
                           "count": ("pod",)}
    return specs


def param_shapes(cfg) -> dict:
    """The arch's param tree as SDS leaves, from its spec, with nothing
    allocated."""
    from repro_torch.models import grouped
    from repro_torch.models.rglru import RGLRUConfig
    from repro_torch.models.xlstm import XLSTMConfig
    if isinstance(cfg, XLSTMConfig):
        from repro_torch.models.xlstm import _param_specs
    elif isinstance(cfg, RGLRUConfig):
        from repro_torch.models.rglru import _param_specs
    else:
        from repro_torch.models.transformer import _param_specs
    flat = {k: SDS(tuple(shape), cfg.pdtype)
            for k, (shape, _) in _param_specs(cfg).items()}
    return grouped.nest(flat)
