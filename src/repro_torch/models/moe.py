"""Mixture-of-Experts FFN in PyTorch: top-k routing with capacity-based
dispatch, the reference `repro.models.moe`.

The dispatch keeps the reference's static shapes and its results, and
runs with no host sync (the engine's decode block is under sync debug
mode "error" on the card):

  1. top-k expert choice per token (router in f32), ties to the lower
     expert id as `jax.lax.top_k` breaks them (a stable descending sort;
     `torch.topk` promises no order among ties);
  2. the flat (token, expert) assignments sorted by expert id, stably;
  3. each expert's segment of the sorted list found by `searchsorted`
     (no `bincount`, which reads its max on the host); an assignment's
     rank in its segment decides whether it fits the capacity C;
  4. the (E, C) slot table read out of the sorted list by a gather (each
     slot names the sorted position seg_start[e] + c), the (E, C, D)
     expert batch by a second gather, the expert FFNs as batched
     products;
  5. the combine as a gather too: each token's k slot outputs, in
     ascending expert order, summed one after another in the compute
     dtype, the order in which the reference's scatter-add accumulates
     them.  No atomics, so two calls are bitwise equal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def router_topk(x, w_router, k: int):
    """x (T, D), w_router (D, E) -> (weights (T, k) f32, experts (T, k)):
    the k most probable experts, renormalised over the chosen k."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    w, ix = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ix = w[..., :k], ix[..., :k]
    return w / w.sum(dim=-1, keepdim=True), ix


def aux_load_balance_loss(x, w_router, k: int, num_experts: int):
    """Switch-style load-balance auxiliary loss (mean fraction * mean
    prob)."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    _, ix = router_topk(x, w_router, k)
    counts = F.one_hot(ix.reshape(-1), num_experts).sum(0).float()
    frac = counts / counts.sum()
    return num_experts * torch.sum(frac * probs.mean(0))


def capacity_of(t: int, num_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """Slots per expert for a call over `t` tokens (the reference's
    formula)."""
    return int(max(1, (top_k * t * capacity_factor) // num_experts))


def slot_table(experts, weights, t: int, num_experts: int, capacity: int,
               dtype):
    """The (E, C) slot table: token index per expert slot (t = empty) and
    its routing weight in `dtype`, plus for every assignment (T*k, in
    token-major order) the flat slot e*C + rank it landed in, or E*C where
    it was dropped.

    The reference writes every dropped assignment to slot (E-1, C-1) with
    the empty sentinel (`src/repro/models/moe.py:73-78`): that index is in
    bounds, so `mode="drop"` keeps the write, and its scatter applies the
    updates in sorted order.  So when the last expert overflows, its
    dropped assignments come after its rank C-1 and empty that slot; an
    earlier expert's dropped assignments come before it and are
    overwritten.  Slot (E-1, C-1) is empty exactly when count[E-1] > C,
    and the port empties it then, on purpose."""
    e, c = num_experts, capacity
    dev = experts.device
    flat_expert = experts.reshape(-1)
    n = flat_expert.shape[0]
    k = n // t
    flat_token = torch.arange(n, device=dev) // k
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    ids = torch.arange(e, device=dev, dtype=se.dtype)
    seg_start = torch.searchsorted(se, ids)
    counts = torch.searchsorted(se, ids, right=True) - seg_start
    cols = torch.arange(c, device=dev)
    collided = (ids[:, None] == e - 1) & (cols[None] == c - 1) & \
        (counts[e - 1] > c)
    filled = (cols[None] < counts[:, None]) & ~collided         # (E, C)
    src = torch.clamp(seg_start[:, None] + cols[None], max=n - 1)
    slot_token = torch.where(filled, flat_token[order][src], t)
    slot_weight = torch.where(filled, weights.reshape(-1)[order][src],
                              0.0).to(dtype)
    # each assignment's slot: its rank in the sorted segment
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev) - seg_start[se]
    kept = (rank < c) & ~((flat_expert == e - 1) & (rank == c - 1)
                          & (counts[e - 1] > c))
    slot = torch.where(kept, flat_expert * c + rank, e * c)
    return slot_token, slot_weight, slot


def moe_ffn(x, params, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, activation: str = "swiglu"):
    """x (T, D).  params: router (D, E), wi_gate / wi_up (E, D, F),
    wo (E, F, D)."""
    t, d = x.shape
    e = num_experts
    capacity = capacity_of(t, e, top_k, capacity_factor)
    weights, experts = router_topk(x, params["router"], top_k)  # (T, k)
    slot_token, slot_weight, slot = slot_table(
        experts, weights, t, e, capacity, x.dtype)

    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xe = x_pad[slot_token]                                      # (E, C, D)
    if activation == "swiglu":
        h = F.silu(torch.bmm(xe, params["wi_gate"])) * \
            torch.bmm(xe, params["wi_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["wi_gate"]), approximate="tanh")
    ye = torch.bmm(h, params["wo"]) * slot_weight[..., None]    # (E, C, D)

    # combine: token t's contributions in ascending expert order, each a
    # row of ye or the zero row E*C for a dropped assignment
    y_pad = torch.cat([ye.reshape(e * capacity, d), ye.new_zeros((1, d))])
    by_expert = torch.argsort(experts, dim=-1)                  # (T, k)
    slots = slot.reshape(t, top_k).gather(1, by_expert)
    parts = y_pad[slots]                                        # (T, k, D)
    out = x.new_zeros((t, d))
    for j in range(top_k):
        out = out + parts[:, j]
    return out


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, dtype=torch.float32) -> dict:
    """Random expert params with the reference's shapes and scales, drawn
    from the CPU generator `gen`."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5

    def nrm(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype) * scale
    return {"router": nrm((d_model, num_experts), s_in),
            "wi_gate": nrm((num_experts, d_model, d_ff), s_in),
            "wi_up": nrm((num_experts, d_model, d_ff), s_in),
            "wo": nrm((num_experts, d_ff, d_model), s_out)}
