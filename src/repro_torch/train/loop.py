"""Training step construction: gradient accumulation, clipping, AdamW,
schedule.

`make_train_step` returns a (state, batch) -> (state, metrics) function.
It is functional: the new state is made of new tensors and the old one is
left as it was.  `make_fused_steps` runs K such steps with the SDC
screens on the device and returns one (K,) block of metrics and flags;
nothing inside it waits for the device.

`make_sharded_train_step` and `make_sharded_fused_steps` run the same
step on a DeviceMesh: the state is DTensors placed by
`distributed.sharding.train_state_specs` (FSDP on "data", tensor parallel
on "model"), the batch by `batch_specs`, and the model's hints and the
kernels' `local_map`s place the activations.  The gradients are placed
like their params (the FSDP reduce-scatter) before the functional AdamW,
which runs on DTensors.  There is no donation: the step builds the new
state from the old one, which the caller drops, exactly as the unsharded
step does, so neither holds old and new state longer than the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.hints import is_dtensor
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
        grads = [_place_like(g, p) for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        n = tcfg.microbatches
        if n > 1:
            parts = [loss_and_grads(params, {
                k: _microbatch(v, n, i) for k, v in batch.items()})
                for i in range(n)]
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


def _place_like(g, p):
    """A DTensor gradient placed as its param (partial sums reduced and
    scattered); a plain gradient as it is."""
    if not is_dtensor(g):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _microbatch(v, n: int, i: int):
    """Microbatch i of n along dim 0.  A DTensor splits its local rows:
    microbatch i holds each rank's i-th slice, so no row moves between
    ranks (on one rank, the plain split)."""
    if is_dtensor(v):
        from repro_torch.distributed.sharding import dtensor_of
        loc = v.to_local()
        part = loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])[i]
        return dtensor_of(part, v.device_mesh, v.placements,
                          (v.shape[0] // n,) + tuple(v.shape[1:]))
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


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


# --------------------------------------------------------------------------
# on a DeviceMesh
# --------------------------------------------------------------------------
def shard_train_state(state, model_cfg, mesh, *, multi_pod: bool = False):
    """A train state of global tensors (the same on every rank) ->
    DTensors placed by `train_state_specs`."""
    from repro_torch.distributed.sharding import (distribute, param_specs,
                                                  train_state_specs)
    pspecs = param_specs(model_cfg, multi_pod=multi_pod)
    return distribute(state, train_state_specs(pspecs), mesh)


def shard_batch(batch, mesh, *, multi_pod: bool = False,
                block: bool = False):
    """A batch (or, with `block`, a (K, ...) block of batches) of global
    tensors -> DTensors placed by `batch_specs` (the block axis
    unsharded)."""
    from repro_torch.distributed.sharding import (batch_specs, distribute,
                                                  prepend_axis)
    specs = batch_specs("vlm" if "positions" in batch else "tokens",
                        multi_pod)
    return distribute(batch, prepend_axis(specs) if block else specs, mesh)


def _plain(x):
    """A DTensor metric -> its full value as a plain tensor."""
    return x.full_tensor() if is_dtensor(x) else x


def _on_mesh(fn, mesh):
    """fn run with `mesh` ambient and plain tensors taken as replicated."""
    from repro_torch.distributed.hints import on_mesh

    def wrapped(*args):
        with on_mesh(mesh):
            return fn(*args)
    return wrapped


def make_sharded_train_step(model_cfg, fns, tcfg: TrainConfig, mesh,
                            example_batch=None, *, multi_pod: bool = False
                            ) -> Callable:
    """make_train_step on `mesh`: (state, batch) -> (state, metrics), the
    state DTensors placed by `train_state_specs` (a state of global
    tensors is placed on the first call: `shard_train_state`), the batch
    placed by `batch_specs` (`shard_batch`; global tensors are placed
    here), the metrics plain replicated tensors.  Specs that do not
    divide on this mesh are dropped, so the same call runs on the
    one-rank test mesh and on a production mesh.  `example_batch` is
    taken for the reference's signature; the batch itself says its
    kind."""
    step = _on_mesh(make_train_step(model_cfg, fns, tcfg), mesh)

    def sharded(state, batch):
        if not is_dtensor(tree_leaves(state["params"])[0]):
            state = shard_train_state(state, model_cfg, mesh,
                                      multi_pod=multi_pod)
        if not is_dtensor(next(iter(batch.values()))):
            batch = shard_batch(batch, mesh, multi_pod=multi_pod)
        new_state, metrics = step(state, batch)
        return new_state, {k: _plain(v) for k, v in metrics.items()}

    return sharded


def make_sharded_fused_steps(model_cfg, fns, tcfg: TrainConfig, mesh,
                             example_batch=None, *, drain_every: int = 8,
                             window: int = 32, min_screen: int = 8,
                             multi_pod: bool = False) -> Callable:
    """make_fused_steps on `mesh`: the state placed as in
    make_sharded_train_step, the screen ring replicated (plain tensors,
    the same on every rank), the (K, ...) batch block placed on its batch
    axes with the step axis unsharded.  `drain_every` and `window` are
    taken for the reference's signature; the block and the ring carry
    their own sizes."""
    step = make_sharded_train_step(model_cfg, fns, tcfg, mesh,
                                   multi_pod=multi_pod)
    fused = make_fused_steps(model_cfg, fns, tcfg, min_screen, step_fn=step)

    def sharded(state, screen, batches, thresholds):
        if not is_dtensor(next(iter(batches.values()))):
            batches = shard_batch(batches, mesh, multi_pod=multi_pod,
                                  block=True)
        return fused(state, screen, batches, thresholds)

    return sharded
