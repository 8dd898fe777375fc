"""Training step construction: gradient accumulation, clipping, AdamW,
schedule.

`make_train_step` returns a (state, batch) -> (state, metrics) function.
It is functional: the new state is made of new tensors and the old one is
left as it was.  `make_fused_steps` runs K such steps with the SDC
screens on the device and returns one (K,) block of metrics and flags;
nothing inside it waits for the device.  Sharded variants (the reference's
`make_sharded_*`) wait for the distributed slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.sync import no_host_sync

from .fault_tolerance import screen_update
from .optimizer import (AdamWConfig, adamw_update, clip_by_global_norm,
                        init_opt_state)
from .schedule import get_schedule
from .tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1        # gradient accumulation


def init_train_state(gen: torch.Generator, cfg, fns, device="cuda") -> dict:
    params = fns.init(gen, cfg, device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train_state_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's train state {params, opt: {m, v, step}, step} for
    any family, exported leaf by leaf with `np.asarray`, as a port train
    state on `device` (the layout `init_train_state` makes)."""
    def params(t):
        return registry.model_fns(cfg).params_from_jax(t, cfg, device)

    def scalar(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)
    opt = tree["opt"]
    return {"params": params(tree["params"]),
            "opt": {"m": params(opt["m"]), "v": params(opt["v"]),
                    "step": scalar(opt["step"])},
            "step": scalar(tree["step"])}


def make_train_step(model_cfg, fns, tcfg: TrainConfig) -> Callable:
    sched = get_schedule(tcfg.schedule)

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            loss = fns.loss_fn(tree_unflatten(params, leaves), batch,
                               model_cfg)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        n = tcfg.microbatches
        if n > 1:
            parts = [loss_and_grads(params, {
                k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                for k, v in batch.items()}) for i in range(n)]
            loss = torch.stack([p[0] for p in parts]).mean()
            grads = tree_map(lambda *g: torch.stack(g).mean(0),
                             *[p[1] for p in parts])
        else:
            loss, grads = loss_and_grads(params, batch)

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.adamw.grad_clip)
            lr_scale = sched(state["step"], warmup=tcfg.warmup_steps,
                             total=tcfg.total_steps)
            new_params, new_opt = adamw_update(params, grads, state["opt"],
                                               tcfg.adamw, lr_scale)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
        return new_state, metrics

    return train_step


def make_eval_step(model_cfg, fns) -> Callable:
    @torch.no_grad()
    def eval_step(state, batch):
        return fns.loss_fn(state["params"], batch, model_cfg)
    return eval_step


def make_fused_steps(model_cfg, fns, tcfg: TrainConfig,
                     min_screen: int = 8, step_fn: Callable | None = None
                     ) -> Callable:
    """K train steps with the SDC screens on the device.

    Returns fused(state, screen, batches, thresholds) -> (state, screen,
    block): `batches` carries a leading K axis, `screen` is a
    fault_tolerance.screen_init ring buffer, `thresholds` a device
    (loss_thr, gnorm_thr) pair, and `block` the (K,)-shaped metrics and
    screen flags the host drains in one transfer per K steps.  On a CUDA
    device the K steps run under sync debug mode "error": an operation
    that waits for the device raises.

    `step_fn` overrides the inner step (tests use it to inject faults).
    """
    step_fn = step_fn or make_train_step(model_cfg, fns, tcfg)

    def fused(state, screen, batches, thresholds):
        k = next(iter(batches.values())).shape[0]
        rows = []
        with no_host_sync(thresholds.device):
            for i in range(k):
                state, m = step_fn(state, {n: v[i] for n, v in
                                           batches.items()})
                screen, flags = screen_update(
                    screen, m["loss"], m["grad_norm"], thresholds[0],
                    thresholds[1], min_screen)
                rows.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                             "lr_scale": m["lr_scale"], **flags})
            block = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
        return state, screen, block

    return fused
