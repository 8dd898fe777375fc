"""AdamW optimizer (f32 states, decoupled weight decay) + global-norm clip,
on nested dicts of tensors.

`adamw_update` is functional, as the reference's is: it returns new param
and state tensors and leaves its inputs untouched, so a supervisor can
recompute a step from the same state (duplicate-step checks) and the
fused and per-step loops run the same arithmetic.  It runs under
`torch.no_grad()`.  Every scalar it produces stays on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, grads), g


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step.  lr_scale: schedule multiplier (a device scalar is
    fine).  Returns (new_params, new_state)."""
    step = state["step"] + 1
    grads = tree_map(lambda g: g.float(), grads)
    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g,
                 state["m"], grads)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                 state["v"], grads)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, m_, v_):
        mhat = m_ / bc1
        vhat = v_ / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:     # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}
