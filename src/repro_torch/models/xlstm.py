"""xLSTM (arXiv:2405.04517) in PyTorch: alternating sLSTM / mLSTM residual
blocks, the reference `repro.models.xlstm`.

- mLSTM: a matrix memory C per head with exponential input and forget
  gates.  A whole sequence runs the paper's parallel (quadratic, masked)
  form with log-space stabilisation, or its chunkwise form past
  `mlstm_chunk` positions; decode runs the O(1) recurrent step.
- sLSTM: a scalar memory with exponential gating and per-head recurrent
  weights, strictly sequential: a Python loop over time, in f32, takes
  the place of the reference's `lax.scan`.

Parameters are a nested dict in the reference's layout ("slstm" and
"mlstm" groups, each leaf with a leading pair axis), so `params_from_jax`
maps one onto the other leaf by leaf; a Python loop over pairs takes the
place of `lax.scan`.  The decode cache holds every carry in f32 (the
exponential-gate stabiliser keeps them there) and `decode_step` returns
fresh tensors, as the reference does.

Serving prefills by running the decode cell over the bucket
(`prefill_cells`), so prefill and decode are one recurrence bit for bit.
No kernel of its own: the family runs GEMMs, batched products and
elementwise ops, and the mLSTM's log-forget prefix sums go through the
RG-LRU scan kernel B4 at a = 1 (`_prefix_sum`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.hints import (embed_rows, gather_fsdp,
                                          is_dtensor, merge_heads,
                                          shard_hint, split_heads,
                                          weight_grad_placements)
from repro_torch.kernels.rglru_scan import rglru_scan

from . import grouped
from .layers import rms_norm
from .losses import chunked_lm_loss, softmax_xent


@dataclass(frozen=True)
class XLSTMConfig:
    name: str = "xlstm"
    n_layers: int = 24                 # alternating sLSTM, mLSTM (pairs)
    d_model: int = 1024
    n_heads: int = 4
    vocab_size: int = 50304
    proj_factor: float = 2.0           # mLSTM up-projection
    mlstm_chunk: int = 256             # chunkwise-parallel form block size
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 0                # seq-chunked xent (0 = off)

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def hd(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def n_pairs(self) -> int:
        return self.n_layers // 2

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        return sum(int(np.prod(shape)) for shape, _ in
                   _param_specs(self).values())

    def active_param_count(self) -> int:
        return self.param_count()


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _param_specs(cfg: XLSTMConfig) -> dict:
    """Flat "group/leaf" name -> (shape, init) in a fixed order; init is
    the std of a normal draw, or "ones" / "zeros"."""
    d, di, h, p = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.n_pairs
    s, si, dhs = d ** -0.5, di ** -0.5, d // h
    slstm = {"norm": ((p, d), "ones"), "w_gates": ((p, d, 4 * d), s),
             "r_gates": ((p, h, 4 * dhs, dhs), dhs ** -0.5),
             "b_gates": ((p, 4 * d), "zeros"), "w_out": ((p, d, d), s)}
    mlstm = {"norm": ((p, d), "ones"), "w_up": ((p, d, di), s),
             "w_gate": ((p, d, di), s), "w_q": ((p, di, di), si),
             "w_k": ((p, di, di), si), "w_v": ((p, di, di), si),
             "w_if": ((p, di, 2 * h), si), "b_if": ((p, 2 * h), "zeros"),
             "skip_norm": ((p, di), "ones"), "w_down": ((p, di, d), si)}
    spec = {"embed": ((cfg.vocab_size, d), 1.0)}
    spec.update({f"slstm/{k}": v for k, v in slstm.items()})
    spec.update({f"mlstm/{k}": v for k, v in mlstm.items()})
    spec["final_norm"] = ((d,), "ones")
    return spec


def init_params(gen: torch.Generator, cfg: XLSTMConfig,
                device="cuda") -> dict:
    """Random params with the reference's shapes and scales, drawn from
    `gen` on its own device in a fixed order (a CPU generator gives the
    same weights on any device) and moved to `device` in param_dtype."""
    return grouped.draw(_param_specs(cfg), gen, cfg.pdtype, device)


def params_from_jax(tree, cfg: XLSTMConfig, device="cuda") -> dict:
    """The reference's param pytree, exported leaf by leaf with
    `np.asarray`, as port params on `device` (same names, shapes,
    dtypes)."""
    return grouped.from_jax(tree, _param_specs(cfg), device)


def cast_params(params: dict, cfg: XLSTMConfig) -> dict:
    """One compute-dtype copy of every block weight, the final norm and
    the unembedding ("head"); see `grouped.cast`."""
    return grouped.cast(params, cfg.cdtype)


_layer = grouped.layer


# --------------------------------------------------------------------------
# sLSTM cell (sequential; exponential gating with a stabiliser state m)
# --------------------------------------------------------------------------
def _slstm_block(cfg: XLSTMConfig, x, lp, state=None):
    """x (B, S, D) -> (x + block, (c, n, m, h) f32 carries after the last
    position).  state: the carries to start from (None = fresh)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    lp = _gather_weights(lp)
    xn = rms_norm(x, lp["norm"])
    # placed whole before the head split (4 heads on a wider model axis)
    gates_x = shard_hint(xn @ lp["w_gates"] + lp["b_gates"],
                         ("batch", None, None)).reshape(b, s, 4, h, dh)
    # the reference's einsum of the f32 carry and the recurrent weights
    # promotes the weights to f32
    r = lp["r_gates"].reshape(h, 4, dh, dh).float()
    hs, carry = _local(_slstm_scan, r, gates_x, *(state or ()),
                       n_weights=1, carries=4)
    out = merge_heads(hs, None).to(x.dtype)
    return x + _rows(out @ lp["w_out"]), carry


def _slstm_scan(r, gates_x, *state):
    """The sLSTM recurrence over gates_x (B, S, 4, H, dh) from `state`
    (c, n, m, h), fresh when empty.  Returns (h per position (B, S, H,
    dh), (c, n, m, h) after the last)."""
    b, s, _, h, dh = gates_x.shape
    if not state:
        zeros = torch.zeros((b, h, dh), dtype=torch.float32,
                            device=gates_x.device)
        c, n, hprev = zeros, zeros, zeros
        m = torch.full((b, h, dh), -torch.inf, device=gates_x.device)
    else:
        c, n, m, hprev = state
    hs = []
    for t in range(s):
        gx = gates_x[:, t].float()                       # (B, 4, H, dh)
        pre = gx + torch.einsum("bhd,hgde->bghe", hprev, r)
        z = torch.tanh(pre[:, 0])
        i_, f_ = pre[:, 1], pre[:, 2]
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(f_ + m, i_)                # log-space stabiliser
        i_g = torch.exp(i_ - m_new)
        f_g = torch.exp(f_ + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        m = m_new
        hprev = o * c / torch.maximum(torch.abs(n), torch.ones_like(n))
        hs.append(hprev)
    return torch.stack(hs, 1), (c, n, m, hprev)


def _rows(t):
    """A block output placed as the residual stream: batch over the dp
    axes, replicated on "model"."""
    return shard_hint(t, ("batch", None, None))


def _local(fn, *args, n_weights: int = 0, carries: int = 0):
    """fn(*args) on plain tensors.  On DTensors, under `local_map`: the
    first `n_weights` arguments replicated, the others placed batch-major
    (dim 0 over the dp axes, replicated on "model"), so the xLSTM cores
    run whole on each rank's rows, as the reference's heads (4 on a
    16-way axis) stay replicated.  fn returns one tensor, or (tensor,
    tuple of `carries` tensors)."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    placed = [shard_hint(a, (None,) * a.dim()) if i < n_weights else
              shard_hint(a, ("batch",) + (None,) * (a.dim() - 1))
              for i, a in enumerate(args)]
    rows = list(placed[n_weights].placements)
    flat = fn if not carries else \
        (lambda *a: (lambda o: (o[0], *o[1]))(fn(*a)))
    data = placed[n_weights]
    out = local_map(flat, out_placements=(rows,) * (1 + carries)
                    if carries else rows,
                    in_placements=tuple(tuple(a.placements)
                                        for a in placed),
                    in_grad_placements=tuple(
                        weight_grad_placements(a, data) if i < n_weights
                        else tuple(a.placements)
                        for i, a in enumerate(placed)),
                    device_mesh=placed[0].device_mesh,
                    redistribute_inputs=False)(*placed)
    return (out[0], tuple(out[1:])) if carries else out


# --------------------------------------------------------------------------
# mLSTM: parallel and chunkwise (whole sequence), recurrent (decode)
# --------------------------------------------------------------------------
def _prefix_sum(x):
    """Running sum along axis 1 of an f32 (B, S, H) tensor, added in order
    in f32: the RG-LRU scan at a = 1 (h_t = 1 * h_{t-1} + x_t; 1 * h is
    exact), so its forward and backward are kernels on the card and the
    card equals the CPU bitwise.  A float `torch.cumsum` has no
    deterministic CUDA kernel (it raises under
    `torch.use_deterministic_algorithms(True)`, the mode the trainer's
    bitwise checks run in), and on the CPU it sums in double."""
    return rglru_scan(torch.ones_like(x), x)


def _mlstm_parallel(q, k, v, ifg):
    """q, k, v (B, S, H, dh); ifg (B, S, 2H) pre-activations.  Stabilised
    masked linear attention with exponential gates (xLSTM eq. 19-27)."""
    b, s, h, dh = q.shape
    i_pre = ifg[..., :h].float()                        # (B, S, H)
    logf = F.logsigmoid(ifg[..., h:].float())
    cum = _prefix_sum(logf)
    # D_ij = exp(F_i - F_j + i_j) for j <= i, stabilised per row
    logd = cum[:, :, None, :] - cum[:, None, :, :] + i_pre[:, None, :, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logd = torch.where(mask[None, :, :, None], logd, -torch.inf)
    m = torch.clamp(torch.amax(logd, dim=2, keepdim=True), min=-1e30)
    dmat = torch.exp(logd - m)
    scores = torch.einsum("bqhd,bkhd->bqkh", q.float() * dh ** -0.5,
                          k.float())
    w = scores * dmat
    norm = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m[:, :, 0]))
    out = torch.einsum("bqkh,bkhd->bqhd", w, v.float())
    return (out / norm[..., None]).to(v.dtype)


def _mlstm_chunked(q, k, v, ifg, chunk: int = 256):
    """Chunkwise-parallel mLSTM: O(S * chunk) memory instead of O(S^2).
    Within a chunk the masked quadratic form; across chunks a recurrent
    (C, n, m) triple carries the matrix memory, advanced a chunk at a
    time.  Equals `_mlstm_parallel`."""
    b, s, h, dh = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        # padded steps: i = -inf (zero weight), f = 0 (harmless)
        ifg = F.pad(ifg, (0, 0, 0, pad), value=-1e30)
    nchunk = (s + pad) // chunk
    dev = q.device

    def chunks(t):
        return t.reshape(b, nchunk, chunk, *t.shape[2:])

    qs = chunks(q.float() * dh ** -0.5)                 # (B, N, C, H, dh)
    ks, vs = chunks(k.float()), chunks(v.float())
    i_pre = chunks(ifg[..., :h].float())                # (B, N, C, H)
    f_raw = ifg[..., h:]
    f_pre = chunks(torch.where(f_raw > -1e29, F.logsigmoid(f_raw.float()),
                               0.0))
    c_st = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    n_st = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
    m_st = torch.full((b, h), -torch.inf, device=dev)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    outs = []
    for j in range(nchunk):
        qc, kc, vc, ic, fc = (t[:, j] for t in (qs, ks, vs, i_pre, f_pre))
        lam = _prefix_sum(fc)                           # (B, C, H)
        g = ic - lam
        big = torch.maximum(m_st[:, None], torch.cummax(g, dim=1).values)
        logd = g[:, None, :, :] - big[:, :, None, :]    # (B, Cq, Ck, H)
        dmat = torch.exp(torch.where(tri[None, :, :, None], logd,
                                     -torch.inf))
        w = torch.einsum("bqhd,bkhd->bqkh", qc, kc) * dmat
        inter = torch.exp(m_st[:, None] - big)          # (B, C, H)
        num = (torch.einsum("bqkh,bkhd->bqhd", w, vc)
               + inter[..., None] * torch.einsum("bqhd,bhde->bqhe", qc,
                                                 c_st))
        nvec = (inter[..., None] * n_st[:, None]
                + torch.einsum("bqkh,bkhd->bqhd", dmat, kc))
        m_t = lam + big
        den = torch.maximum(torch.abs((qc * nvec).sum(-1)), torch.exp(-m_t))
        outs.append(num / den[..., None])
        # the carry at the chunk's end
        big_last, lam_last = big[:, -1], lam[:, -1]     # (B, H)
        kw = torch.exp(g - big_last[:, None])[..., None] * kc
        decay = torch.exp(m_st - big_last)
        c_st = (decay[..., None, None] * c_st
                + torch.einsum("bkhd,bkhe->bhde", kw, vc))
        n_st = decay[..., None] * n_st + kw.sum(dim=1)
        m_st = lam_last + big_last
    out = torch.stack(outs, 1).reshape(b, s + pad, h, dh)[:, :s]
    return out.to(v.dtype)


def _mlstm_block(cfg: XLSTMConfig, x, lp, state=None):
    """x (B, S, D) -> (x + block, new (C, n, m) carries for a decode step,
    else None).  state: the carries of a one-position decode step."""
    b, s, _ = x.shape
    h, dh, di = cfg.n_heads, cfg.hd, cfg.d_inner
    lp = _gather_weights(lp)
    xn = rms_norm(x, lp["norm"])
    xu = shard_hint(xn @ lp["w_up"], ("batch", None, "model"))  # (B,S,Di)
    zg = shard_hint(F.silu(xn @ lp["w_gate"]), ("batch", None, "model"))
    q = split_heads(xu @ lp["w_q"], h, dh, None)
    k = split_heads(xu @ lp["w_k"], h, dh, None)
    v = split_heads(xu @ lp["w_v"], h, dh, None)
    ifg = xu @ lp["w_if"] + lp["b_if"]                  # (B, S, 2H)

    if state is None:
        if s > cfg.mlstm_chunk:
            out = _local(lambda *a: _mlstm_chunked(*a, cfg.mlstm_chunk),
                         q, k, v, ifg)
        else:
            out = _local(_mlstm_parallel, q, k, v, ifg)
        new_state = None
    else:
        out, new_state = _local(_mlstm_step, q, k, v, ifg, *state,
                                carries=3)
        out = out.to(x.dtype)
    out = rms_norm(merge_heads(out.reshape(b, s, h, dh), None),
                   lp["skip_norm"]) * zg
    return x + _rows(out @ lp["w_down"]), new_state


def _mlstm_step(q, k, v, ifg, c, n, m):
    """One recurrent mLSTM position: q, k, v (B, 1, H, dh), ifg (B, 1,
    2H), carries (C, n, m).  Returns (out (B, 1, H * dh) f32, new
    carries)."""
    b, _, h, dh = q.shape
    i_pre = ifg[:, 0, :h].float()                       # (B, H)
    logf = F.logsigmoid(ifg[:, 0, h:].float())
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None, None]
    f_g = torch.exp(logf + m - m_new)[..., None, None]
    kf = k[:, 0].float() * dh ** -0.5
    vf = v[:, 0].float()
    c_new = f_g * c + i_g * (kf[..., :, None] * vf[..., None, :])
    n_new = f_g[..., 0] * n + i_g[..., 0] * kf
    qf = q[:, 0].float()
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    # stabilised states hold exp(-m)-scaled values: the max(|.|, 1)
    # floor becomes exp(-m) in the scaled representation
    den = torch.maximum(torch.abs((qf * n_new).sum(-1)),
                        torch.exp(-m_new))
    return (num / den[..., None]).reshape(b, 1, h * dh), (c_new, n_new,
                                                           m_new)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
# the weights' in-loop specs (the reference's): a DTensor weight's FSDP
# dim is gathered at block entry
_WSPECS = {
    "w_gates": ("fsdp", "model"), "w_out": ("fsdp", "model"),
    "w_up": ("fsdp", "model"), "w_gate": ("fsdp", "model"),
    "w_q": ("fsdp", "model"), "w_k": ("fsdp", "model"),
    "w_v": ("fsdp", "model"), "w_if": ("fsdp", None),
    "w_down": ("model", "fsdp"),
}


def _gather_weights(lp):
    """A block's weights at their compute placements; plain weights as
    they are."""
    if not is_dtensor(next(iter(lp.values()))):
        return lp
    return {k: (gather_fsdp(v, _WSPECS[k]) if k in _WSPECS else v)
            for k, v in lp.items()}


def _embed(params, tokens, cfg: XLSTMConfig):
    return embed_rows(params["embed"], tokens).to(cfg.cdtype)


def _head(params):
    return gather_fsdp(params["head"], ("fsdp", "model"))


def _pair(cfg, x, sl, ml):
    x, _ = _slstm_block(cfg, x, sl)
    return _mlstm_block(cfg, x, ml)[0]


def _trunk(params, tokens, cfg: XLSTMConfig):
    """Embeddings -> pairs -> final norm, from cast params."""
    x = _embed(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_pairs):
        sl, ml = _layer(params["slstm"], i), _layer(params["mlstm"], i)
        if remat:
            # no dropout anywhere, so no RNG state to stash and replay
            x = checkpoint(_pair, cfg, x, sl, ml, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _pair(cfg, x, sl, ml)
        x = shard_hint(x, ("batch", None, None))
    return rms_norm(x, params["final_norm"])


def forward(params, tokens, cfg: XLSTMConfig, positions=None):
    """tokens (B, S) int -> logits (B, S, V)."""
    params = cast_params(params, cfg)
    return shard_hint(_trunk(params, tokens, cfg) @ _head(params),
                      ("batch", None, "model"))


def loss_fn(params, batch, cfg: XLSTMConfig):
    """Mean next-token cross-entropy over batch {tokens, labels}; with
    cfg.loss_chunk dividing the sequence, chunk by chunk."""
    labels = batch["labels"]
    params = cast_params(params, cfg)
    x = _trunk(params, batch["tokens"], cfg)
    if cfg.loss_chunk and labels.shape[-1] % cfg.loss_chunk == 0:
        return chunked_lm_loss(x, _head(params), labels,
                               chunk=cfg.loss_chunk)
    return softmax_xent(x @ _head(params), labels).mean()


def init_cache(cfg: XLSTMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """The recurrent state only, O(1) in sequence length.  `dtype` is
    taken for the uniform signature but unused: the exponential-gate
    stabiliser keeps every carry in f32.  "pos" is a scalar; the serving
    spec makes it per-row."""
    p, h, dh, dhs = cfg.n_pairs, cfg.n_heads, cfg.hd, cfg.d_model // \
        cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "slstm": (torch.zeros((p, batch, h, dhs), **f32),
                  torch.zeros((p, batch, h, dhs), **f32),
                  torch.full((p, batch, h, dhs), -torch.inf, **f32),
                  torch.zeros((p, batch, h, dhs), **f32)),
        "mlstm": (torch.zeros((p, batch, h, dh, dh), **f32),
                  torch.zeros((p, batch, h, dh), **f32),
                  torch.full((p, batch, h), -torch.inf, **f32)),
        "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _stack_states(states):
    return tuple(torch.stack(leaf) for leaf in zip(*states))


def decode_step(params, cache, tokens, cfg: XLSTMConfig, positions=None):
    """tokens (B, 1) -> (logits (B, V), cache): every pair's carries
    advanced one position, as fresh tensors; pos advanced by 1."""
    params = cast_params(params, cfg)
    x = _embed(params, tokens, cfg)
    s_states, m_states = [], []
    for i in range(cfg.n_pairs):
        x, st = _slstm_block(cfg, x, _layer(params["slstm"], i),
                             state=tuple(t[i] for t in cache["slstm"]))
        s_states.append(st)
        x, st = _mlstm_block(cfg, x, _layer(params["mlstm"], i),
                             state=tuple(t[i] for t in cache["mlstm"]))
        m_states.append(st)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["head"])[:, -1], {
        "slstm": _stack_states(s_states), "mlstm": _stack_states(m_states),
        "pos": cache["pos"] + 1}


def prefill_cells(params, tokens, lens, cfg: XLSTMConfig):
    """Ragged bucketed prefill: the decode cell run over the bucket, each
    row's carries frozen once past its own prompt length.  It is the
    decode recurrence itself, so prefill + decode is one recurrence bit
    for bit.

    tokens (B, bucket); lens (B,).  Returns (last-token logits (B, V),
    per-row decode state with pos = lens)."""
    from .decode_state import admit_merge     # it imports this module
    params = cast_params(params, cfg)
    b, lb = tokens.shape
    state = init_cache(cfg, b, 0, device=tokens.device)
    state["pos"] = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    axes = {"slstm": (1, 1, 1, 1), "mlstm": (1, 1, 1), "pos": 0}
    logits = torch.zeros((b, cfg.vocab_size), dtype=cfg.cdtype,
                         device=tokens.device)
    for t in range(lb):
        lg, fresh = decode_step(params, state, tokens[:, t:t + 1], cfg)
        state = admit_merge(state, fresh, axes, t < lens)
        logits = torch.where((t == lens - 1)[:, None], lg, logits)
    return logits, state
