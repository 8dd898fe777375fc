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
(`_wire_sim_hop`).

On a DeviceMesh (`make_diloco_round(mesh=...)`) the pod axis of the
state shards over "pod" (`distributed.sharding.diloco_specs`): each rank
runs its own n_pods / pod_size pods' inner steps, each sharded over
"data" x "model" on the mesh's (data, model) sub-mesh, and the outer hop
is `_wire_shard_hop`: each rank quantizes its own tile of each pod delta
and all-gathers only the compressed payload over the "pod" group.

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
from repro_torch.distributed import sharding
from repro_torch.distributed.hints import is_dtensor
from repro_torch.sync import no_host_sync

from .fault_tolerance import screen_init, screen_update
from .loop import TrainConfig, make_train_step
from .optimizer import init_opt_state
from .tree import tree_leaves, tree_map

# the outer sync's wire budget: per-pod payload bytes within this factor
# of `outer_wire_bytes` for its declared compress mode (the dry run's
# --check compares per pod against per pod)
LINT_BUDGET = {"host_callbacks": 0, "outer_wire_budget_factor": 2.0}


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


def _pod_group(mesh):
    return mesh["pod"].get_group()


def _all_gather_pods(x, group, size: int):
    """(p_loc, ...) from each rank of the pod group -> (size * p_loc, ...)
    in pod-rank order."""
    import torch.distributed as dist
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _wire_shard_hop(deltas, ef, pod_mask, denom, fmt):
    """The wire hop over the mesh's "pod" group: each rank quantizes its
    own tile of each of its pods' deltas (blocks padded inside the tile,
    so they never straddle a shard boundary) and all-gathers only the
    compressed payload (int8 q + f32 scales, or top-k f32 values + int32
    lane-local indices) over the pod group; the decode and the masked
    mean happen after the gather.  `deltas` and `ef` are DTensors placed
    by `diloco_specs` (the pod axis on "pod"); `pod_mask` and `denom`
    plain tensors.  Returns (outer grad tree placed like the params, new
    EF tree placed like `ef`): bitwise `_wire_sim_hop` on the same
    layout."""
    mesh = fmt.mesh
    pod_dim = mesh.mesh_dim_names.index("pod")
    n_pod_ranks = mesh.size(pod_dim)
    p_loc = fmt.n_pods // n_pod_ranks
    group = _pod_group(mesh)
    row0 = mesh.get_local_rank(pod_dim) * p_loc
    w = pod_mask.float().reshape(-1, 1)
    w_own = w[row0:row0 + p_loc]

    def leaf_hop(d, e, lay):
        d_loc, e_loc = d.to_local(), e.to_local()
        t = d_loc.reshape(p_loc, -1) + e_loc.reshape(p_loc, -1)
        m = t.shape[1]
        if fmt.method == "int8":
            q, scale = codec.int8_wire_compress(t, fmt.block)
            sent_all = codec.int8_wire_decompress(
                _all_gather_pods(q, group, n_pod_ranks),
                _all_gather_pods(scale, group, n_pod_ranks), m)
        else:
            vals, idx = codec.topk_wire_compress(t, fmt.topk_frac)
            sent_all = codec.topk_wire_decompress(
                _all_gather_pods(vals, group, n_pod_ranks),
                _all_gather_pods(idx, group, n_pod_ranks), m)
        grad = torch.sum(sent_all * w, dim=0) / denom
        resid = torch.where(w_own > 0, t - sent_all[row0:row0 + p_loc],
                            e_loc.reshape(p_loc, -1))
        return (sharding.dtensor_of(grad.reshape(d_loc.shape[1:]), mesh,
                           _replica_placements(d), tuple(d.shape[1:])),
                sharding.dtensor_of(resid.reshape(e_loc.shape), mesh, e.placements,
                           tuple(e.shape)))

    pairs = tree_map(leaf_hop, deltas, ef, fmt.layout)
    grad = tree_map(lambda d, p: p[0], deltas, pairs)
    new_ef = tree_map(lambda d, p: p[1], deltas, pairs)
    return grad, new_ef


def _replica_placements(d):
    """A pod-axis DTensor's placements for one replica: the pod dim's
    Shard(0) becomes Replicate, every other Shard moves down one dim."""
    from torch.distributed.tensor import Replicate, Shard
    pod_dim = d.device_mesh.mesh_dim_names.index("pod")
    return [Replicate() if i == pod_dim else
            (Shard(p.dim - 1) if isinstance(p, Shard) else p)
            for i, p in enumerate(d.placements)]


def _mean_shard_hop(deltas, pod_mask, denom):
    """The uncompressed hop over the "pod" group: each rank sums its own
    pods' masked deltas on its tile and one f32 all-reduce over the pod
    group adds the pods' sums (the reference's masked-mean all-reduce).
    Returns the outer grad tree placed like the params."""
    import torch.distributed as dist

    def leaf(d):
        mesh = d.device_mesh
        pod_dim = mesh.mesh_dim_names.index("pod")
        d_loc = d.to_local()
        p_loc = d_loc.shape[0]
        row0 = mesh.get_local_rank(pod_dim) * p_loc
        w = _pod_weights(pod_mask[row0:row0 + p_loc].float(), d_loc.dim())
        part = torch.sum(d_loc * w, dim=0)
        dist.all_reduce(part, group=_pod_group(mesh))
        return sharding.dtensor_of(part / denom, mesh, _replica_placements(d),
                          tuple(d.shape[1:]))
    return tree_map(leaf, deltas)


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
    single-lane layout.  wire: a `WireFormat` (overrides `compress`):
    with a mesh, the hop is `_wire_shard_hop` over its "pod" group (the
    d_state then holds DTensors placed by `diloco_specs`); without one,
    the simulated hop in the same lane layout.  A d_state of DTensors
    without compression averages the deltas with one f32 all-reduce per
    leaf over the pod group (`_mean_shard_hop`).
    """
    layout, block = None, 256
    if wire is not None:
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
    if wire is not None and wire.mesh is not None:
        grad, new_ef = _wire_shard_hop(deltas, d_state["pod_ef"], pod_mask,
                                       denom, wire)
    elif compress is not None:
        grad, new_ef = _wire_sim_hop(deltas, d_state["pod_ef"], pod_mask,
                                     denom, compress, block, topk_frac,
                                     layout)
    elif is_dtensor(tree_leaves(deltas)[0]):
        grad = _mean_shard_hop(deltas, pod_mask, denom)
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
    new_pods = tree_map(lambda gp, old: _place_like(
        _stack_pods(gp, dcfg.n_pods), old), new_global, d_state["pod_params"])
    out = {**d_state, "global_params": new_global, "outer_m": new_m,
           "pod_params": new_pods}
    if new_ef is not None:
        out["pod_ef"] = new_ef
    return out


def _place_like(x, like):
    """A DTensor re-placed as `like` (the re-broadcast pods back on the
    pod axis: a local slice, no communication); plain tensors as they
    are."""
    if not is_dtensor(x):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def make_diloco_round(model_cfg, fns, tcfg: TrainConfig, dcfg: DiLoCoConfig,
                      *, compress: str | None = None,
                      topk_frac: float = 0.01, data=None,
                      screen_window: int = 0, min_screen: int = 8,
                      mesh=None, supervise: bool = False):
    """One DiLoCo round, on one device or on a DeviceMesh.

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

    With `mesh` (a DeviceMesh with axes ("pod", "data", "model"), n_pods a
    multiple of its pod size): the d_state's params, moments and EF are
    DTensors placed by `diloco_specs` (a d_state from `diloco_init` is
    placed on the first call, `shard_diloco_state`); "step" and the
    screens stay plain tensors, the same on every rank.  Each rank runs
    its own pods' inner steps on the (data, model) sub-mesh
    (`make_sharded_train_step`), the (n_pods, H) metrics are all-gathered
    over the pod group, and with `compress` the hop is `_wire_shard_hop`
    in the lanes of `wire_format_for`.  Supervision, screens and per-pod
    rollback are the unmeshed ones.
    """
    wire_fmt, ctx = None, _no_mesh
    if mesh is None:
        pod_inner = _make_pod_inner(model_cfg, fns, tcfg)
    else:
        pod_inner = _make_mesh_pod_inner(model_cfg, fns, tcfg, dcfg, mesh)
        ctx = _mesh_ctx(mesh)
        if compress is not None:
            wire_fmt = codec.wire_format_for(
                sharding.param_shapes(model_cfg),
                sharding.param_specs(model_cfg), mesh,
                dcfg.n_pods, method=compress, topk_frac=topk_frac)

    def round_fn(d_state, batches, pod_mask, thresholds):
        if mesh is not None and not is_dtensor(
                tree_leaves(d_state["pod_params"])[0]):
            d_state = shard_diloco_state(d_state, model_cfg, mesh)
        with no_host_sync(pod_mask.device), ctx():
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
                                 topk_frac=topk_frac, wire=wire_fmt)
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
                outer_ok = _all_finite(
                    tree_leaves(d_state["global_params"])
                    + tree_leaves(d_state["outer_m"]))
                metrics.update(pod_bad=pod_bad, pod_alive=eff_mask,
                               outer_ok=outer_ok)
        return d_state, metrics

    return round_fn


def _no_mesh():
    import contextlib
    return contextlib.nullcontext()


def _mesh_ctx(mesh):
    """The ambient mesh, with plain tensors taken as replicated."""
    from repro_torch.distributed.hints import on_mesh
    return lambda: on_mesh(mesh)


def _all_finite(leaves):
    """One device bool: every leaf all finite.  DTensors check their own
    shards and agree over the whole group (a MIN all-reduce)."""
    if len(leaves) == 0 or not is_dtensor(leaves[0]):
        return torch.stack([torch.all(torch.isfinite(x.float()))
                            for x in leaves]).all()
    import torch.distributed as dist
    ok = torch.stack([torch.all(torch.isfinite(x.to_local().float()))
                      for x in leaves]).all().to(torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return ok > 0


def shard_diloco_state(d_state, model_cfg, mesh):
    """A d_state of global tensors (the same on every rank, from
    `diloco_init`) -> its params, moments and EF as DTensors placed by
    `diloco_specs`; "step" and "screen" stay plain."""
    specs = sharding.diloco_specs(sharding.param_specs(model_cfg),
                                  compress="pod_ef" in d_state)
    out = dict(d_state)
    for k in ("global_params", "outer_m", "pod_params", "pod_opt",
              "pod_ef"):
        if k in d_state:
            out[k] = sharding.distribute(d_state[k], specs[k], mesh)
    return out


def _pod_slice(x, j: int, sub):
    """Local pod j of a pod-axis DTensor, as a DTensor on the (data,
    model) sub-mesh `sub`."""
    from torch.distributed.tensor import Shard
    pod_dim = x.device_mesh.mesh_dim_names.index("pod")
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for i, p in enumerate(x.placements) if i != pod_dim]
    return sharding.dtensor_of(x.to_local()[j], sub, pl, tuple(x.shape[1:]))


def _pod_stack(xs, like):
    """Local pods (DTensors on the sub-mesh) stacked back into a pod-axis
    DTensor placed as `like`."""
    from torch.distributed.tensor import DTensor
    local = torch.stack([x.to_local() for x in xs])
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _make_mesh_pod_inner(model_cfg, fns, tcfg: TrainConfig,
                         dcfg: DiLoCoConfig, mesh):
    """`_make_pod_inner` on a mesh: this rank's pods, one after another,
    each trained on the (data, model) sub-mesh; the (n_pods, H) losses
    and grad norms all-gathered over the pod group."""
    from .loop import make_sharded_train_step
    names = mesh.mesh_dim_names
    if names != ("pod", "data", "model"):
        raise ValueError(f"a DiLoCo mesh has axes ('pod', 'data', "
                         f"'model'), got {names}")
    n_ranks = mesh.size(0)
    if dcfg.n_pods % n_ranks:
        raise ValueError(f"{dcfg.n_pods} pods do not divide over a pod "
                         f"axis of {n_ranks}")
    p_loc = dcfg.n_pods // n_ranks
    row0 = mesh.get_local_rank(0) * p_loc
    sub = mesh["data", "model"]
    group = _pod_group(mesh)
    step_fn = make_sharded_train_step(model_cfg, fns, tcfg, sub)

    def pod_inner(pod_params, pod_opt, step0, batches):
        h = next(iter(batches.values())).shape[1]
        params, opts, losses, gnorms = [], [], [], []
        for j in range(p_loc):
            state = {"params": tree_map(lambda x: _pod_slice(x, j, sub),
                                        pod_params),
                     "opt": tree_map(lambda x: _pod_slice(x, j, sub),
                                     pod_opt),
                     "step": step0}
            for i in range(h):
                state, metrics = step_fn(
                    state, {k: v[row0 + j, i] for k, v in batches.items()})
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
            params.append(state["params"])
            opts.append(state["opt"])

        def stack(like, *xs):
            return _pod_stack(xs, like)
        rows = torch.stack([torch.stack(losses), torch.stack(gnorms)]
                           ).reshape(2, p_loc, h).transpose(0, 1)
        rows = _all_gather_pods(rows.contiguous(), group, n_ranks)
        return (tree_map(stack, pod_params, *params),
                tree_map(stack, pod_opt, *opts),
                rows[:, 0].contiguous(), rows[:, 1].contiguous())

    return pod_inner


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
        n = math.prod(x.shape)
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
