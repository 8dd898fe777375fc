"""DiLoCo: distributed low-communication training across satellite pods.

The paper (§3) points to DiLoCo as the research direction for fault- and
communication-tolerant training in orbit.  The inner optimizer runs H
steps entirely inside one pod; only the outer step — a parameter delta
averaged over the pods — crosses the FSO inter-satellite links, cutting
ISL traffic by ~H (and ~4x more with int8 delta compression from
`repro_torch.distributed.compression`).

The state keeps the reference's layout: per-pod replicas are a leading
pod axis of the param tree, so checkpoints and the weight carry-over map
leaf to leaf.  On one card the pods' inner steps run one pod after
another over views `x[p]` (the reference vmaps; per-pod math is
independent, so the order changes no result), and their results are
stacked back.  The outer step is a masked mean over per-pod deltas plus
Nesterov momentum, with the wire hop simulated pod-locally
(`_wire_sim_hop`).  The hop over a pod group of cards (the reference's
`_wire_shard_hop`) and the sharded steps wait for ROADMAP A3b.

The pod mask makes satellite loss and stragglers first-class: a masked
pod is excluded from the outer average and rejoins on the re-broadcast
global params.  A round in which every pod is masked leaves the global
params and the outer momentum as they were.

`make_diloco_round` is the hot path: one call runs the H inner AdamW
steps of every pod, the on-device SDC screens, the optional int8/top-k
error-feedback compression and the masked Nesterov outer sync, under
sync debug mode "error" on a CUDA device; the host drains one (n_pods,
H) metrics block per round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed import compression as codec
from repro_torch.sync import no_host_sync

from .fault_tolerance import screen_init, screen_update
from .loop import TrainConfig, make_train_step
from .optimizer import init_opt_state
from .tree import tree_leaves, tree_map

A3B = ("the hop over a pod group of cards (mesh, _wire_shard_hop, "
       "make_sharded_*) is not ported (ROADMAP A3b)")


@dataclass(frozen=True)
class DiLoCoConfig:
    """DiLoCo outer-loop knobs.

    Fields:
      n_pods: satellite-pod replicas — the leading axis of the replicated
        param tree.
      inner_steps: H, local AdamW steps between outer syncs; ISL
        pod-axis traffic drops by ~H vs sync data-parallel.
      outer_lr: Nesterov SGD learning rate on the pod-averaged delta.
      outer_momentum: Nesterov momentum on the outer "gradient".
    """
    n_pods: int = 2
    inner_steps: int = 10           # H
    outer_lr: float = 0.7           # Nesterov SGD on deltas (DiLoCo defaults)
    outer_momentum: float = 0.9


def _stack_pods(x, n_pods: int):
    return x.unsqueeze(0).expand((n_pods,) + tuple(x.shape)).clone()


def diloco_init(params, dcfg: DiLoCoConfig, compress: str | None = None,
                screen_window: int = 0):
    """Global state: master params + outer momentum + per-pod replicas,
    on the params' device.

    compress: "int8"/"topk" adds per-pod error-feedback residuals for the
    compressed wire hop; screen_window > 0 adds per-pod metrics ring
    buffers for the on-device SDC screens.
    """
    n = dcfg.n_pods
    device = tree_leaves(params)[0].device
    state = {
        "global_params": params,
        "outer_m": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
        "pod_params": tree_map(lambda x: _stack_pods(x, n), params),
        "pod_opt": tree_map(lambda x: _stack_pods(x, n),
                            init_opt_state(params)),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if compress is not None:
        state["pod_ef"] = tree_map(lambda x: torch.zeros(
            (n,) + tuple(x.shape), dtype=torch.float32, device=x.device),
            params)
    if screen_window:
        state["screen"] = tree_map(lambda x: _stack_pods(x, n),
                                   screen_init(screen_window, device))
    return state


def _make_pod_inner(model_cfg, fns, tcfg: TrainConfig):
    """H local AdamW steps on each pod's replica, pod after pod.  Returns
    pod_inner(pod_params, pod_opt, step0, batches) -> (pod_params,
    pod_opt, losses, grad_norms), the last two (n_pods, H)."""
    step_fn = make_train_step(model_cfg, fns, tcfg)

    def pod_inner(pod_params, pod_opt, step0, batches):
        n_pods, h = next(iter(batches.values())).shape[:2]
        params, opts, losses, gnorms = [], [], [], []
        for p in range(n_pods):
            state = {"params": tree_map(lambda x: x[p], pod_params),
                     "opt": tree_map(lambda x: x[p], pod_opt),
                     "step": step0}
            for i in range(h):
                state, metrics = step_fn(
                    state, {k: v[p, i] for k, v in batches.items()})
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
            params.append(state["params"])
            opts.append(state["opt"])
        stack = lambda *xs: torch.stack(xs)                   # noqa: E731
        return (tree_map(stack, *params), tree_map(stack, *opts),
                torch.stack(losses).reshape(n_pods, h),
                torch.stack(gnorms).reshape(n_pods, h))

    return pod_inner


def make_inner_steps(model_cfg, fns, tcfg: TrainConfig,
                     dcfg: DiLoCoConfig):
    """H local AdamW steps per pod.  batches: a dict of tensors with
    leading axes (n_pods, H, ...).  Returns inner(d_state, batches) ->
    (d_state, (n_pods,) mean loss per pod).  The same arithmetic as the
    round's inner steps, so make_inner_steps + outer_step is the round
    bitwise."""
    pod_inner = _make_pod_inner(model_cfg, fns, tcfg)

    def inner(d_state, batches):
        new_p, new_o, losses, _ = pod_inner(d_state["pod_params"],
                                            d_state["pod_opt"],
                                            d_state["step"], batches)
        return {**d_state, "pod_params": new_p, "pod_opt": new_o,
                "step": d_state["step"] + dcfg.inner_steps}, \
            losses.mean(dim=-1)

    return inner


def _pod_weights(pod_mask, ndim: int):
    return pod_mask.reshape((-1,) + (1,) * (ndim - 1))


def _wire_sim_hop(deltas, ef, pod_mask, denom, method: str, block: int,
                  topk_frac: float, layout=None):
    """Simulated wire hop: error-feedback compress/decompress each pod's
    delta in the lane layout (`layout`, a tree of WireLeaf; None = the
    single-lane legacy layout), then the masked mean.  Returns (outer
    grad tree, new EF tree).  Masked pods transmit nothing: their EF
    residual is kept.

    The pods' lanes are independent, so all pods go through one call
    with the pod axis as the outermost tile dimension: each pod's lanes
    are quantized and sparsified exactly as one pod alone would be."""
    layout = layout if layout is not None else \
        tree_map(lambda d: None, deltas)

    def per_leaf(d, e, lay):
        counts = (d.shape[0],) + (tuple(lay.counts) if lay is not None
                                  else (1,) * (d.dim() - 1))
        _, sent, resid = codec.ef_wire_roundtrip(d, e, counts, method,
                                                 block, topk_frac)
        w = _pod_weights(pod_mask, e.dim())
        grad = torch.sum(sent * w, dim=0) / denom
        return grad, torch.where(w > 0, resid, e)

    pairs = tree_map(per_leaf, deltas, ef, layout)
    grad = tree_map(lambda d, p: p[0], deltas, pairs)
    new_ef = tree_map(lambda d, p: p[1], deltas, pairs)
    return grad, new_ef


def outer_step(d_state, dcfg: DiLoCoConfig, pod_mask=None,
               compress: str | None = None, topk_frac: float = 0.01,
               wire=None):
    """Nesterov outer update on the pod-averaged delta; re-broadcast.

    pod_mask: (n_pods,) 0/1 tensor — masked pods are excluded from the
    average (and overwritten with the new global params regardless:
    rejoin).  An all-masked round leaves global params and outer momentum
    unchanged.

    compress: "int8"/"topk" runs each surviving pod's delta through the
    error-feedback compressor (d_state must carry "pod_ef") in the
    single-lane layout.  wire: a `WireFormat` (overrides `compress`) whose
    lane layout the simulated hop follows; its mesh must be None.
    """
    layout, block = None, 256
    if wire is not None:
        if wire.mesh is not None:
            raise NotImplementedError(A3B)
        compress, topk_frac = wire.method, wire.topk_frac
        layout, block = wire.layout, wire.block
    if pod_mask is None:
        pod_mask = torch.ones((dcfg.n_pods,), dtype=torch.float32,
                              device=d_state["step"].device)
    pod_mask = pod_mask.float()
    n_alive = torch.sum(pod_mask)
    alive = n_alive > 0
    denom = torch.clamp_min(n_alive, 1.0)

    def per_pod_delta(gp, pp):
        w = _pod_weights(pod_mask, gp.dim() + 1)
        # zero out masked pods before any arithmetic: a NaN-poisoned
        # replica must not leak through the average or the EF state
        return torch.where(w > 0, gp.float()[None] - pp.float(), 0.0)

    deltas = tree_map(per_pod_delta, d_state["global_params"],
                      d_state["pod_params"])
    new_ef = None
    if compress is not None:
        grad, new_ef = _wire_sim_hop(deltas, d_state["pod_ef"], pod_mask,
                                     denom, compress, block, topk_frac,
                                     layout)
    else:
        grad = tree_map(lambda d: torch.sum(
            d * _pod_weights(pod_mask, d.dim()), dim=0) / denom, deltas)
    mom, lr = dcfg.outer_momentum, dcfg.outer_lr
    m = tree_map(lambda m_, g: mom * m_ + g, d_state["outer_m"], grad)
    new_global = tree_map(
        lambda gp, m_, g: torch.where(
            alive, (gp.float() - lr * (mom * m_ + g)).to(gp.dtype), gp),
        d_state["global_params"], m, grad)
    new_m = tree_map(lambda m_new, m_old: torch.where(alive, m_new, m_old),
                     m, d_state["outer_m"])
    new_pods = tree_map(lambda gp: _stack_pods(gp, dcfg.n_pods), new_global)
    out = {**d_state, "global_params": new_global, "outer_m": new_m,
           "pod_params": new_pods}
    if new_ef is not None:
        out["pod_ef"] = new_ef
    return out


def make_diloco_round(model_cfg, fns, tcfg: TrainConfig, dcfg: DiLoCoConfig,
                      *, compress: str | None = None,
                      topk_frac: float = 0.01, data=None,
                      screen_window: int = 0, min_screen: int = 8,
                      mesh=None, supervise: bool = False):
    """One DiLoCo round on one device.

    Returns round(d_state, batches, pod_mask, thresholds) -> (d_state,
    metrics):
      - batches: a dict of tensors with leading (n_pods, H) axes — or,
        when `data` (a SyntheticLM) is given, an (n_pods, H) integer
        tensor of step ids on the device, whose batches are generated on
        the device inside the round;
      - pod_mask: (n_pods,) 0/1 liveness tensor;
      - thresholds: a device (loss_thr, gnorm_thr) pair for the screens
        (ignored when screen_window=0; the d_state must come from
        diloco_init with the same screen_window);
      - metrics: (n_pods, H) loss/grad_norm + screen flags, device
        tensors, for the one per-round host drain.

    Nothing inside the round waits for the device: on a CUDA device it
    runs under sync debug mode "error".  The inputs are not modified.

    supervise=True is the DiLoCoSupervisor contract — per-pod rollback on
    the device: a pod any of whose inner steps tripped a screen is
    excluded from the outer average and rejoins on the re-broadcast
    global params, and its error-feedback residual, optimizer moments
    and screen ring buffer are reset; metrics gain "pod_bad" (n_pods,),
    "pod_alive" (the effective mask) and "outer_ok" (global params and
    outer momentum all finite).
    """
    if mesh is not None:
        raise NotImplementedError(A3B)
    pod_inner = _make_pod_inner(model_cfg, fns, tcfg)

    def round_fn(d_state, batches, pod_mask, thresholds):
        with no_host_sync(pod_mask.device):
            if data is not None:
                batches = data.batch_block(batches)
            new_p, new_o, losses, gnorms = pod_inner(
                d_state["pod_params"], d_state["pod_opt"], d_state["step"],
                batches)
            d_state = {**d_state, "pod_params": new_p, "pod_opt": new_o,
                       "step": d_state["step"] + dcfg.inner_steps}

            if screen_window:
                screens, rows = [], []
                for p in range(dcfg.n_pods):
                    s = tree_map(lambda x: x[p], d_state["screen"])
                    pod_flags = []
                    for i in range(dcfg.inner_steps):
                        s, f = screen_update(s, losses[p, i], gnorms[p, i],
                                             thresholds[0], thresholds[1],
                                             min_screen)
                        pod_flags.append(f)
                    screens.append(s)
                    rows.append({k: torch.stack([f[k] for f in pod_flags])
                                 for k in pod_flags[0]})
                stack = lambda *xs: torch.stack(xs)           # noqa: E731
                d_state = {**d_state, "screen": tree_map(stack, *screens)}
                flags = tree_map(stack, *rows)
            else:
                nonfinite = ~(torch.isfinite(losses)
                              & torch.isfinite(gnorms))
                no = torch.zeros_like(nonfinite)
                flags = {"nonfinite": nonfinite, "loss_spike": no,
                         "gnorm_spike": no, "suspect": nonfinite}

            metrics = {"loss": losses, "grad_norm": gnorms, **flags}
            eff_mask = pod_mask
            if supervise:
                pod_bad = torch.any(flags["suspect"], dim=1)
                eff_mask = pod_mask * (1.0 - pod_bad.float())
            d_state = outer_step(d_state, dcfg, eff_mask, compress=compress,
                                 topk_frac=topk_frac)
            if supervise:
                def reset_rows(tree, init_row=None):
                    def per_leaf(x, i=None):
                        w = _pod_weights(pod_bad, x.dim())
                        zero = torch.zeros_like(x) if i is None else \
                            i.to(x.dtype).expand_as(x)
                        return torch.where(w, zero, x)
                    if init_row is None:
                        return tree_map(per_leaf, tree)
                    return tree_map(per_leaf, tree, init_row)

                # zeroed moments and step == a fresh init_opt_state row:
                # the rejoining pod restarts from the re-broadcast globals
                d_state = {**d_state,
                           "pod_opt": reset_rows(d_state["pod_opt"])}
                if "pod_ef" in d_state:
                    d_state = {**d_state,
                               "pod_ef": reset_rows(d_state["pod_ef"])}
                if screen_window:
                    init = tree_map(lambda x: x[None], screen_init(
                        screen_window, pod_mask.device))
                    d_state = {**d_state, "screen": reset_rows(
                        d_state["screen"], init)}
                outer_ok = torch.stack(
                    [torch.all(torch.isfinite(x.float()))
                     for x in (tree_leaves(d_state["global_params"])
                               + tree_leaves(d_state["outer_m"]))]).all()
                metrics.update(pod_bad=pod_bad, pod_alive=eff_mask,
                               outer_ok=outer_ok)
        return d_state, metrics

    return round_fn


def snapshot_global_params(d_state):
    """Fresh device tensors holding the outer (global) params at the drain
    boundary — the co-residency publish hook.  A device-to-device copy:
    no host transfer, no host sync, and tensors that stay valid however
    the caller's d_state moves on."""
    return tree_map(lambda x: x.clone(), d_state["global_params"])


def outer_wire_bytes(params, compress: str | None = None,
                     topk_frac: float = 0.01, wire=None) -> int:
    """Per-pod FSO bytes for one outer sync, from static shapes: the
    wire format's lane layout when `wire` is given, else the single-lane
    formulas."""
    if wire is not None:
        from repro_torch.distributed.compression import wire_tree_bytes
        return wire_tree_bytes(params, wire)
    total = 0
    for x in tree_leaves(params):
        n = math.prod(x.shape) if x.dim() else 1
        if compress == "int8":
            rows = -(-n // 256)
            total += rows * 256 + rows * 4       # int8 payload + f32 scales
        elif compress == "topk":
            k = max(1, int(n * topk_frac))
            total += 8 * k                       # f32 values + i32 indices
        else:
            total += 4 * n
    return total


def isl_bytes_per_step(n_params: int, inner_steps: int,
                       compress: str | None = None,
                       topk_frac: float = 0.01) -> dict:
    """ISL (pod-axis) traffic accounting: sync DP vs DiLoCo (§3)."""
    sync = 4 * n_params                       # f32 grad all-reduce every step
    outer = 4 * n_params / inner_steps        # amortized delta sync
    if compress == "int8":
        outer /= 4                            # int8 payload vs f32
    elif compress == "topk":
        outer *= 8 * topk_frac / 4            # f32 value + i32 index per kept
    return {"sync_bytes_per_step": sync,
            "diloco_bytes_per_step": outer,
            "reduction": sync / outer}
