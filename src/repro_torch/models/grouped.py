"""Params of the families whose reference layout nests its weights one
level deep ("group/leaf": RG-LRU's rec_a / rec_b / attn / tail, xLSTM's
slstm / mlstm), beside top-level "embed" and "final_norm".  A family
describes its params by a flat spec, name -> (shape, init), in a fixed
order; these helpers draw, import and cast them."""
from __future__ import annotations

import numpy as np
import torch


def nest(flat: dict) -> dict:
    """{"group/leaf": t, "name": t} -> {"group": {"leaf": t}, "name": t}."""
    out = {}
    for name, t in flat.items():
        grp, _, leaf = name.rpartition("/")
        (out.setdefault(grp, {}) if grp else out)[leaf] = t
    return out


def draw(specs: dict, gen: torch.Generator, dtype, device) -> dict:
    """Random params from `specs`, whose init is the std of a normal draw,
    a (low, high) uniform range, or "ones" / "zeros", drawn from `gen` on
    the generator's own device in spec order and moved to `device` in
    `dtype`.  A CPU generator gives the same weights on any device; a
    CUDA generator draws on the card."""
    flat = {}
    src = gen.device
    for name, (shape, init) in specs.items():
        if init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif isinstance(init, tuple):
            t = torch.empty(shape, dtype=dtype, device=src).uniform_(
                *init, generator=gen)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype,
                            device=src) * init
        flat[name] = t.to(device)
    return nest(flat)


def from_jax(tree, specs: dict, device) -> dict:
    """The reference's param pytree, exported leaf by leaf with
    `np.asarray`, as port params on `device`; its names and shapes must be
    the spec's."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    if set(flat) != set(specs):
        raise ValueError(f"param names differ from the config's: "
                         f"{sorted(set(flat) ^ set(specs))}")
    out = {}
    for name, arr in flat.items():
        if tuple(arr.shape) != specs[name][0]:
            raise ValueError(f"{name}: shape {arr.shape} != {specs[name][0]}")
        out[name] = torch.from_numpy(np.array(arr)).to(device)
    return nest(out)


def cast(params: dict, cd) -> dict:
    """One `cd` copy of every group's weights (the reference casts a whole
    block before use) and of the final norm, plus "head" (the cast
    unembedding matrix, embed.T).  The embedding table stays in
    param_dtype: the reference gathers rows before the cast.
    Already-cast params pass through unchanged."""
    if "head" in params:
        return params
    out = {k: ({kk: vv.to(cd) for kk, vv in v.items()}
               if isinstance(v, dict) else v) for k, v in params.items()}
    out["final_norm"] = params["final_norm"].to(cd)
    out["head"] = params["embed"].T.to(cd)
    return out


def layer(group: dict, i: int) -> dict:
    """Layer `i` of a group whose leaves carry a leading layer axis."""
    return {k: v[i] for k, v in group.items()}
