"""RecurrentGemma / Griffin (arXiv:2402.19427) in PyTorch: RG-LRU recurrent
blocks and local attention, 2:1, the reference `repro.models.rglru`.

Block pattern: groups of (recurrent, recurrent, local-attention), each
block followed by a GeGLU MLP, then `n_layers - 3 * n_groups` tail
recurrent blocks.  The RG-LRU diagonal recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t),   r_t, i_t = sigmoid(W x)

runs over a whole sequence (prefill, forward, loss) through the RG-LRU
scan kernel B4 (`kernels/rglru_scan`: the CUDA kernel for CUDA tensors,
its plain sequential version for CPU tensors), and as an O(1) state update
in decode.  The reference picks its scan through `scan_impl`; the port has
no switch.  Local attention decodes over a W-slot ring, one row per query,
through the dense decode-attention kernel B1; over a whole sequence it
runs the plain windowed attention, or with `attn_impl="chunked"` (the
dry run's setting, as the reference's) the online softmax over KV blocks.

Parameters are a nested dict in the reference's layout: "rec_a", "rec_b"
and "attn" with a leading n_groups axis, "tail" with a leading
n_tail_rec axis, so `params_from_jax` maps one onto the other leaf by
leaf; Python loops over groups take the place of `lax.scan`.

The decode cache holds per-layer RG-LRU states (h (G, B, D) f32, conv
tail (G, B, cw-1, D)), which `decode_step` returns as fresh tensors, and
the attention ring (G, B, W, Hkv, hd), which it writes in place and
returns.  The reference returns fresh arrays throughout; the values are
the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.hints import (embed_rows, gather_fsdp,
                                          heads_axis, is_dtensor,
                                          merge_heads, shard_hint,
                                          split_heads, write_rows)
from repro_torch.kernels.rglru_scan import rglru_scan

from . import grouped
from .layers import apply_rope, attention, geglu, rms_norm, rope_cos_sin
from .losses import chunked_lm_loss, softmax_xent

RG_LRU_C = 8.0


@dataclass(frozen=True)
class RGLRUConfig:
    name: str = "recurrentgemma"
    n_layers: int = 26                  # 8 x (rec, rec, attn) + 2 rec
    d_model: int = 2560
    n_heads: int = 10
    n_kv_heads: int = 1                 # MQA
    d_ff: int = 7680
    vocab_size: int = 256000
    window: int = 2048
    conv_width: int = 4
    rope_base: float = 10000.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 0                # seq-chunked xent (0 = off)
    attn_impl: str = "ref"             # "chunked": prefill over KV blocks

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // 3

    @property
    def n_tail_rec(self) -> int:
        return self.n_layers - 3 * self.n_groups

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
def _rec_specs(cfg: RGLRUConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = d ** -0.5
    return {"norm": ((n, d), "ones"), "w_x": ((n, d, d), s),
            "w_gate": ((n, d, d), s), "conv": ((n, cfg.conv_width, d), 0.1),
            "w_ri": ((n, d, 2 * d), s), "b_ri": ((n, 2 * d), "zeros"),
            "lam": ((n, d), (0.5, 2.0)), "w_out": ((n, d, d), s),
            "mlp_norm": ((n, d), "ones"), "wi_gate": ((n, d, f), s),
            "wi_up": ((n, d, f), s), "wo_mlp": ((n, f, d), f ** -0.5)}


def _attn_specs(cfg: RGLRUConfig, n: int) -> dict:
    d, hd, h, hkv, f = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_ff)
    s = d ** -0.5
    return {"norm": ((n, d), "ones"), "wq": ((n, d, h * hd), s),
            "wk": ((n, d, hkv * hd), s), "wv": ((n, d, hkv * hd), s),
            "wo": ((n, h * hd, d), (h * hd) ** -0.5),
            "mlp_norm": ((n, d), "ones"), "wi_gate": ((n, d, f), s),
            "wi_up": ((n, d, f), s), "wo_mlp": ((n, f, d), f ** -0.5)}


def _param_specs(cfg: RGLRUConfig) -> dict:
    """Flat "group/leaf" name -> (shape, init) in a fixed order; init is
    the std of a normal draw, a (low, high) uniform range, or "ones" /
    "zeros"."""
    g = cfg.n_groups
    groups = {"rec_a": _rec_specs(cfg, g), "rec_b": _rec_specs(cfg, g),
              "attn": _attn_specs(cfg, g)}
    if cfg.n_tail_rec:
        groups["tail"] = _rec_specs(cfg, cfg.n_tail_rec)
    spec = {"embed": ((cfg.vocab_size, cfg.d_model), 1.0)}
    for grp, leaves in groups.items():
        spec.update({f"{grp}/{k}": v for k, v in leaves.items()})
    spec["final_norm"] = ((cfg.d_model,), "ones")
    return spec


def init_params(gen: torch.Generator, cfg: RGLRUConfig,
                device="cuda") -> dict:
    """Random params with the reference's shapes and scales, drawn from
    `gen` on its own device in a fixed order (a CPU generator gives the
    same weights on any device) and moved to `device` in param_dtype."""
    return grouped.draw(_param_specs(cfg), gen, cfg.pdtype, device)


def params_from_jax(tree, cfg: RGLRUConfig, device="cuda") -> dict:
    """The reference's param pytree, exported leaf by leaf with
    `np.asarray`, as port params on `device` (same names, shapes,
    dtypes)."""
    return grouped.from_jax(tree, _param_specs(cfg), device)


def cast_params(params: dict, cfg: RGLRUConfig) -> dict:
    """One compute-dtype copy of every block weight (lam and the conv
    taps too: the reference casts the whole block before use), the final
    norm and the unembedding ("head"); see `grouped.cast`."""
    return grouped.cast(params, cfg.cdtype)


_layer = grouped.layer


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _gather_rows(t, idx):
    """t (B, S, ...) and idx (B, K) -> t[b, idx[b, k]] of shape (B, K,
    ...)."""
    shape = idx.shape + (1,) * (t.dim() - 2)
    return t.gather(1, idx.long().reshape(shape).expand(
        *idx.shape, *t.shape[2:]))


def _rec_block(cfg: RGLRUConfig, x, lp, state=None, lens=None):
    """Griffin recurrent block.  state: (h (B, D) f32, conv tail
    (B, cw-1, D)) for a decode step, None for a whole sequence.

    Returns (x, state): the decode step's new state (fresh tensors); with
    `lens` (B,), each row's carry and conv tail at its own prompt tail
    (position lens-1: the scan is causal, so pad positions past it never
    touch them); None for a whole sequence without `lens`."""
    b, s, d = x.shape
    lp = _gather_weights(lp)
    xn = rms_norm(x, lp["norm"])
    branch = shard_hint(xn @ lp["w_x"], ("batch", None, "model"))
    gate = shard_hint(torch.nn.functional.gelu(xn @ lp["w_gate"],
                                               approximate="tanh"),
                      ("batch", None, "model"))

    # causal depthwise conv1d of width cw, summed in the reference's
    # order 0 + t0 + t1 + ... in the compute dtype
    w = lp["conv"]
    cw = w.shape[0]
    pad = (branch.new_zeros((b, cw - 1, d)) if state is None
           else state[1].to(branch.dtype))
    xc = torch.cat([pad, branch], dim=1)
    conv = sum(xc[:, i:i + s] * w[i] for i in range(cw))

    ri = shard_hint(xn @ lp["w_ri"] + lp["b_ri"], ("batch", None, None))
    r = shard_hint(torch.sigmoid(ri[..., :d].float()),
                   ("batch", None, "model"))
    i_g = shard_hint(torch.sigmoid(ri[..., d:].float()),
                     ("batch", None, "model"))
    log_a = -RG_LRU_C * _softplus(lp["lam"].float()) * r
    gated = (i_g * conv.float()) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))

    ret = None
    if state is None:
        h = rglru_scan(torch.exp(log_a), gated)
        if lens is not None:
            last = torch.clamp(lens - 1, min=0)
            h_last = _gather_rows(h, last[:, None])[:, 0]
            pidx = last[:, None] + (torch.arange(cw - 1, device=x.device)
                                    - (cw - 2))[None]
            tail = _gather_rows(branch, torch.clamp(pidx, 0, s - 1))
            tail = torch.where((pidx >= 0)[:, :, None], tail, 0)
            ret = (h_last.float(), tail)
    else:
        h = torch.exp(log_a[:, 0]) * state[0] + gated[:, 0]
        ret = (h, xc[:, -(cw - 1):])
        h = h[:, None]
    x = x + _rows(h.to(x.dtype) * gate @ lp["w_out"])
    h2 = rms_norm(x, lp["mlp_norm"])
    return x + _rows(geglu(h2, lp["wi_gate"], lp["wi_up"],
                           lp["wo_mlp"])), ret


def _rows(t):
    """A block output placed as the residual stream: batch over the dp
    axes, replicated on "model" (row-parallel partial sums reduced)."""
    return shard_hint(t, ("batch", None, None))


def _attn_block(cfg: RGLRUConfig, x, lp, cache=None, pos0=0, lens=None):
    """Local (windowed) MQA block.  cache: the (ck, cv) ring of
    (B, W, Hkv, hd) for decode, written in place at slot pos % W; pos0 a
    scalar or a (B,) per-row position vector.  Without a cache, windowed
    causal attention over the whole sequence; with `lens` (B,) it also
    returns the ring each row's prompt would have left: slot r holds the
    roped k/v of the latest prompt position p < lens with p = r (mod W)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lp = _gather_weights(lp)
    xn = rms_norm(x, lp["norm"])
    q = split_heads(xn @ lp["wq"], h, hd, heads_axis(h))
    k = split_heads(xn @ lp["wk"], hkv, hd, None)
    v = split_heads(xn @ lp["wv"], hkv, hd, None)
    new_cache = None
    if cache is None:
        cos, sin = rope_cos_sin(torch.arange(s, device=x.device), hd,
                                cfg.rope_base, cfg.cdtype)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = attention(q, k, v, impl=cfg.attn_impl, causal=True,
                         window=cfg.window)
        if lens is not None:
            W = cfg.window
            last = torch.clamp(lens - 1, min=0)[:, None]
            p_r = last - ((last - torch.arange(W, device=x.device)[None])
                          % W)
            pc = torch.clamp(p_r, 0, s - 1)
            valid = (p_r >= 0)[:, :, None, None]
            new_cache = tuple(
                torch.where(valid, _gather_rows(t, pc), 0).to(cfg.cdtype)
                for t in (k, v))
    else:
        ck, cv = cache
        W = ck.shape[1]
        if torch.is_tensor(pos0) and pos0.dim() == 1:
            # per-row positions (continuous batching)
            pos = pos0[:, None] + torch.arange(s, device=x.device)
            rows = torch.arange(b, device=x.device)[:, None]
            cols = pos % W
        else:
            pos = pos0 + torch.arange(s, device=x.device)
            rows = slice(None)
            cols = pos % W
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_base, cfg.cdtype)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        write_rows(ck, rows, cols, k)
        write_rows(cv, rows, cols, v)
        # the ring holds the last W positions; unfilled slots are masked
        filled = torch.clamp(torch.as_tensor(pos0, device=x.device) + s,
                             max=W)
        attn = attention(q, ck, cv, causal=False, kv_len=filled)
        new_cache = (ck, cv)
    x = x + _rows(merge_heads(attn, heads_axis(h)) @ lp["wo"])
    h2 = rms_norm(x, lp["mlp_norm"])
    return x + _rows(geglu(h2, lp["wi_gate"], lp["wi_up"],
                           lp["wo_mlp"])), new_cache


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
# the weights' in-loop specs (the reference's): a DTensor weight's FSDP
# dim is gathered at block entry
_WSPECS = {
    "w_x": ("fsdp", "model"), "w_gate": ("fsdp", "model"),
    "w_ri": ("fsdp", "model"), "w_out": ("model", "fsdp"),
    "wi_gate": ("fsdp", "model"), "wi_up": ("fsdp", "model"),
    "wo_mlp": ("model", "fsdp"), "wq": ("fsdp", "model"),
    "wk": ("fsdp", None), "wv": ("fsdp", None), "wo": ("model", "fsdp"),
}


def _gather_weights(lp):
    """A block's weights at their compute placements; plain weights as
    they are."""
    if not is_dtensor(next(iter(lp.values()))):
        return lp
    return {k: (gather_fsdp(v, _WSPECS[k]) if k in _WSPECS else v)
            for k, v in lp.items()}


def _embed(params, tokens, cfg: RGLRUConfig):
    return embed_rows(params["embed"], tokens).to(cfg.cdtype)


def _unembed(params, x):
    head = gather_fsdp(params["head"], ("fsdp", "model"))
    return shard_hint(x @ head, ("batch", None, "model"))


def _group(cfg, x, ra, rb, at):
    x, _ = _rec_block(cfg, x, ra)
    x, _ = _rec_block(cfg, x, rb)
    return _attn_block(cfg, x, at)[0]


def _trunk(params, tokens, cfg: RGLRUConfig):
    """Embeddings -> groups -> tail -> final norm, from cast params."""
    x = _embed(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        lps = [_layer(params[n], g) for n in ("rec_a", "rec_b", "attn")]
        if remat:
            # no dropout anywhere, so no RNG state to stash and replay
            x = checkpoint(_group, cfg, x, *lps, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _group(cfg, x, *lps)
        x = shard_hint(x, ("batch", None, None))
    for i in range(cfg.n_tail_rec):
        x, _ = _rec_block(cfg, x, _layer(params["tail"], i))
    return rms_norm(x, params["final_norm"])


def forward(params, tokens, cfg: RGLRUConfig):
    """tokens (B, S) int -> logits (B, S, V)."""
    params = cast_params(params, cfg)
    return _unembed(params, _trunk(params, tokens, cfg))


def loss_fn(params, batch, cfg: RGLRUConfig):
    """Mean next-token cross-entropy over batch {tokens, labels}; with
    cfg.loss_chunk dividing the sequence, chunk by chunk."""
    labels = batch["labels"]
    params = cast_params(params, cfg)
    x = _trunk(params, batch["tokens"], cfg)
    if cfg.loss_chunk and labels.shape[-1] % cfg.loss_chunk == 0:
        return chunked_lm_loss(x, gather_fsdp(params["head"],
                                              ("fsdp", "model")),
                               labels, chunk=cfg.loss_chunk)
    return softmax_xent(_unembed(params, x), labels).mean()


def init_cache(cfg: RGLRUConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """O(window) attention ring + O(1) recurrent states, independent of
    max_len.  "pos" is a scalar; the serving spec makes it per-row."""
    dtype = dtype or cfg.cdtype
    d, cw, g = cfg.d_model, cfg.conv_width, cfg.n_groups

    def rec_state(n):
        return (torch.zeros((n, batch, d), dtype=torch.float32,
                            device=device),
                torch.zeros((n, batch, cw - 1, d), dtype=dtype,
                            device=device))

    ring = (g, batch, cfg.window, cfg.n_kv_heads, cfg.hd)
    cache = {"rec_a": rec_state(g), "rec_b": rec_state(g),
             "attn": (torch.zeros(ring, dtype=dtype, device=device),
                      torch.zeros(ring, dtype=dtype, device=device)),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.n_tail_rec:
        cache["tail"] = rec_state(cfg.n_tail_rec)
    return cache


def _stack_states(states):
    return tuple(torch.stack(leaf) for leaf in zip(*states))


def decode_step(params, cache, tokens, cfg: RGLRUConfig):
    """tokens (B, S_new) -> (last-position logits (B, V), cache).  The
    recurrent states come back as fresh tensors, the ring written in
    place, pos advanced by S_new."""
    params = cast_params(params, cfg)
    x = _embed(params, tokens, cfg)
    pos0 = cache["pos"]
    ck, cv = cache["attn"]
    sa, sb = [], []
    for g in range(cfg.n_groups):
        x, st = _rec_block(cfg, x, _layer(params["rec_a"], g),
                           state=(cache["rec_a"][0][g],
                                  cache["rec_a"][1][g]))
        sa.append(st)
        x, st = _rec_block(cfg, x, _layer(params["rec_b"], g),
                           state=(cache["rec_b"][0][g],
                                  cache["rec_b"][1][g]))
        sb.append(st)
        x, _ = _attn_block(cfg, x, _layer(params["attn"], g),
                           cache=(ck[g], cv[g]), pos0=pos0)
    new = {"rec_a": _stack_states(sa), "rec_b": _stack_states(sb),
           "attn": (ck, cv), "pos": pos0 + x.shape[1]}
    if cfg.n_tail_rec:
        st_t = []
        for i in range(cfg.n_tail_rec):
            x, st = _rec_block(cfg, x, _layer(params["tail"], i),
                               state=(cache["tail"][0][i],
                                      cache["tail"][1][i]))
            st_t.append(st)
        new["tail"] = _stack_states(st_t)
    x = rms_norm(x[:, -1:], params["final_norm"])
    return _unembed(params, x)[:, -1], new


def prefill_cells(params, tokens, lens, cfg: RGLRUConfig):
    """Ragged bucketed prefill: the whole-sequence trunk (the RG-LRU scan
    through kernel B4) with each row's carry and ring extracted at its own
    prompt tail (lens - 1).  Every block is causal, so a row padded to the
    bucket reads the state an unpadded run would.

    tokens (B, bucket); lens (B,) prompt lengths.  Returns (last-token
    logits (B, V), per-row decode state with pos = lens)."""
    params = cast_params(params, cfg)
    x = _embed(params, tokens, cfg)
    sa, sb, rings = [], [], []
    for g in range(cfg.n_groups):
        x, st = _rec_block(cfg, x, _layer(params["rec_a"], g), lens=lens)
        sa.append(st)
        x, st = _rec_block(cfg, x, _layer(params["rec_b"], g), lens=lens)
        sb.append(st)
        x, ring = _attn_block(cfg, x, _layer(params["attn"], g), lens=lens)
        rings.append(ring)
    cache = {"rec_a": _stack_states(sa), "rec_b": _stack_states(sb),
             "attn": _stack_states(rings), "pos": lens.to(torch.int32)}
    if cfg.n_tail_rec:
        st_t = []
        for i in range(cfg.n_tail_rec):
            x, st = _rec_block(cfg, x, _layer(params["tail"], i), lens=lens)
            st_t.append(st)
        cache["tail"] = _stack_states(st_t)
    last = torch.clamp(lens - 1, min=0)
    xl = _gather_rows(x, last[:, None])[:, 0]
    return rms_norm(xl, params["final_norm"]) @ params["head"], cache
