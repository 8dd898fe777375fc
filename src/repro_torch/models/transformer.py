"""Decoder-only transformer LM in PyTorch: the dense GQA and the MoE
branches of the reference `repro.models.transformer`.

Parameters are a plain dict with per-layer weights stacked on a leading L
axis, as in the reference, so `params_from_jax` maps one onto the other
leaf by leaf; a Python loop over layers takes the place of `lax.scan`.

Serving writes the KV cache (and the paged pool) in place: `decode_step`
and `paged_decode_step` return the same k/v tensors they were given,
updated, and a new `pos`.  The reference returns fresh arrays; the values
are the same.

Training differentiates `loss_fn` with autograd: `cast_params` is part of
the graph, so gradients reach the param_dtype masters, and the tied
`head = embed.T` accumulates into `embed`.  With `cfg.remat` each block
runs under `torch.utils.checkpoint` (the reference's `jax.checkpoint` with
nothing saveable): the backward pass recomputes the block, attention
kernel included.

The MoE branch (granite-moe, qwen3-moe) replaces each block's MLP with
the capacity-routed expert FFN of `models/moe.py`.  The other branches
are the reference's too: GeGLU and GELU MLPs, the parallel attention +
FFN block (command-r), sinusoidal positions (musicgen), M-RoPE over
(3, B, S) position ids (qwen2-vl) and multi-codebook token streams
(musicgen: tokens (B, n_q, S), the codebooks' embeddings summed, logits
(B, n_q, S, V) from one head per codebook).

`init_params` draws on its generator's device: a CPU generator gives the
same weights on any device, a CUDA generator draws on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.hints import (embed_rows, gather_fsdp,
                                          is_dtensor, merge_heads,
                                          mesh_axis_size, shard_hint,
                                          split_heads, write_rows)

from .layers import (_qpos, apply_rope, attention, gelu_mlp, geglu,
                     layer_norm, mrope_cos_sin, rms_norm, rope_cos_sin,
                     swiglu)
from .losses import chunked_lm_loss, softmax_xent
from .moe import moe_ffn


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    rope_base: float = 10000.0
    qkv_bias: bool = False
    parallel_block: bool = False          # Command-R style
    norm: str = "rmsnorm"                 # or "layernorm"
    mlp_act: str = "swiglu"               # "geglu" | "gelu"
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # modality / position
    mrope_sections: Optional[tuple] = None   # qwen2-vl
    n_codebooks: int = 1                     # musicgen
    pos_embed: str = "rope"                  # "sinusoidal" for musicgen
    window: Optional[int] = None             # local attention
    # scaling / tying
    tie_embeddings: bool = True
    embed_scale: float = 1.0                 # minicpm: 12.0
    residual_scale: float = 1.0              # minicpm: 1.4/sqrt(L)
    logit_scale: float = 1.0                 # command-r: 0.0625
    # implementation
    attn_impl: str = "ref"                   # "chunked" | "pallas"
    loss_chunk: int = 0                      # seq-chunked xent (0 = off)
    fsdp_hints: bool = False                 # keep param slices sharded in-loop
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    max_decode_len: int = 0                  # serving cache length

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

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
        """Per-token active params (the total for dense; k/E of the experts
        for MoE)."""
        total = self.param_count()
        if not self.is_moe:
            return total
        expert = 3 * self.d_model * self.d_ff * self.num_experts * \
            self.n_layers
        return total - expert + expert * self.top_k // self.num_experts


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _param_specs(cfg: TransformerConfig) -> dict:
    """Flat name -> (shape, init) in a fixed order; init is the std of a
    normal draw, ("shared", std) for one draw broadcast over the leading L
    axis (the reference gives every layer the same initial router and
    experts), or "ones" / "zeros".  Layer weights start with "layers/"
    and carry a leading L axis."""
    hd, h, hkv, d, L, f = (cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model,
                           cfg.n_layers, cfg.d_ff)
    s = d ** -0.5
    spec = {"layers/attn_norm": ((L, d), "ones"),
            "layers/wq": ((L, d, h * hd), s),
            "layers/wk": ((L, d, hkv * hd), s),
            "layers/wv": ((L, d, hkv * hd), s),
            "layers/wo": ((L, h * hd, d), (h * hd) ** -0.5)}
    if cfg.norm == "layernorm":
        spec["layers/attn_norm_bias"] = ((L, d), "zeros")
    if cfg.qkv_bias:
        spec["layers/bq"] = ((L, h * hd), "zeros")
        spec["layers/bk"] = ((L, hkv * hd), "zeros")
        spec["layers/bv"] = ((L, hkv * hd), "zeros")
    if not cfg.parallel_block:
        spec["layers/mlp_norm"] = ((L, d), "ones")
        if cfg.norm == "layernorm":
            spec["layers/mlp_norm_bias"] = ((L, d), "zeros")
    if cfg.is_moe:
        e = cfg.num_experts
        spec["layers/router"] = ((L, d, e), ("shared", s))
        spec["layers/moe_wi_gate"] = ((L, e, d, f), ("shared", s))
        spec["layers/moe_wi_up"] = ((L, e, d, f), ("shared", s))
        spec["layers/moe_wo"] = ((L, e, f, d), ("shared", f ** -0.5))
    elif cfg.mlp_act == "gelu":
        spec["layers/wi"] = ((L, d, f), s)
        spec["layers/bi"] = ((L, f), "zeros")
        spec["layers/wo_mlp"] = ((L, f, d), f ** -0.5)
        spec["layers/bo"] = ((L, d), "zeros")
    else:
        spec["layers/wi_gate"] = ((L, d, f), s)
        spec["layers/wi_up"] = ((L, d, f), s)
        spec["layers/wo_mlp"] = ((L, f, d), f ** -0.5)
    nq, v = cfg.n_codebooks, cfg.vocab_size
    spec["embed"] = (((nq, v, d) if nq > 1 else (v, d)), 1.0)
    spec["final_norm"] = ((d,), "ones")
    if cfg.norm == "layernorm":
        spec["final_norm_bias"] = ((d,), "zeros")
    if not cfg.tie_embeddings:
        spec["lm_head"] = (((nq, d, v) if nq > 1 else (d, v)), s)
    return spec


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device="cuda") -> dict:
    """Random params with the reference's shapes and scales, drawn from
    `gen` on the generator's own device in a fixed order and moved to
    `device` in param_dtype.  A CPU generator gives the same weights on
    any device; a CUDA generator draws on the card (the full-width
    configs' billions of draws take minutes on the host)."""
    params = {"layers": {}}
    dt = cfg.pdtype
    for name, (shape, init) in _param_specs(cfg).items():
        if init == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif isinstance(init, tuple):
            one = torch.randn(shape[1:], generator=gen, dtype=dt,
                              device=gen.device)
            t = (one * init[1]).to(device).expand(shape).contiguous()
        else:
            t = torch.randn(shape, generator=gen, dtype=dt,
                            device=gen.device) * init
        group, _, leaf = name.rpartition("/")
        (params["layers"] if group else params)[leaf] = t.to(device)
    return params


def params_from_jax(tree, cfg: TransformerConfig, device="cuda") -> dict:
    """The reference's param pytree, exported leaf by leaf with
    `np.asarray`, as port params on `device` (same names, shapes, dtypes)."""
    want = _param_specs(cfg)
    flat = {("layers/" + k): v for k, v in tree["layers"].items()}
    flat.update({k: v for k, v in tree.items() if k != "layers"})
    if set(flat) != set(want):
        raise ValueError(f"param names differ from the config's: "
                         f"{sorted(set(flat) ^ set(want))}")
    params = {"layers": {}}
    for name, arr in flat.items():
        if tuple(arr.shape) != want[name][0]:
            raise ValueError(f"{name}: shape {arr.shape} != {want[name][0]}")
        group, _, leaf = name.rpartition("/")
        (params["layers"] if group else params)[leaf] = \
            torch.from_numpy(np.array(arr)).to(device)
    return params


def cast_params(params: dict, cfg: TransformerConfig) -> dict:
    """One compute-dtype copy of every weight the blocks, the final norm
    and the unembed read, plus "head" (the cast unembedding matrix, (d,
    V), or (n_q, d, V) for a multi-codebook model).  The
    reference casts the param_dtype weights inside every block call; the
    values are identical, the port pays the cast once.  The embedding
    table stays in param_dtype: the reference gathers and scales rows
    before the cast.  Already-cast params pass through unchanged."""
    if "head" in params:
        return params
    cd = cfg.cdtype
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(cd) for k, v in params["layers"].items()}
    out["final_norm"] = params["final_norm"].to(cd)
    out["head"] = (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
                   else params["lm_head"]).to(cd)
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _norm(cfg, x, w, b=None):
    if cfg.norm == "layernorm":
        return layer_norm(x, w, b)
    return rms_norm(x, w)


def _layer(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


# the residual stream on a mesh: batch over the dp axes, replicated on
# "model" (the reference shards its sequence there, Megatron-SP)
_ROWS = ("batch", None, None)

# the weights' in-loop specs (the reference's, under its fsdp_hints)
_BLOCK_WSPECS = {
    "wq": ("fsdp", "model"), "wk": ("fsdp", "model"), "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"), "wi_gate": ("fsdp", "model"),
    "wi_up": ("fsdp", "model"), "wo_mlp": ("model", "fsdp"),
    "wi": ("fsdp", "model"), "router": ("fsdp", None),
    "moe_wi_gate": ("model", "fsdp", None),
    "moe_wi_up": ("model", "fsdp", None), "moe_wo": ("model", None, "fsdp"),
}


def _block(cfg: TransformerConfig, x, lp, cos, sin, *, q_offset=0,
           cache=None, kv_len=None):
    """One transformer block.  cache: (k, v) of (B, M, Hkv, hd), or the
    paged (k_pool, v_pool, page_table); written in place.

    The hints are the reference's, at its sites, and act only on
    DTensors.  A DTensor weight is gathered over its FSDP dim at block
    entry whatever `fsdp_hints` says (ZeRO-3: left sharded, DTensor may
    gather the activations instead).  Heads shard over "model" when they
    divide it; where they do not, q, k and v are replicated on "model"
    (the reference shards q's sequence there instead, which a causal
    kernel call on a slice of the queries cannot take).  A plain residual
    stream takes none of this: one type test, then the plain code."""
    b, s, _ = x.shape
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    meshed = is_dtensor(x)
    if meshed:
        lp = {k: (gather_fsdp(v, _BLOCK_WSPECS[k]) if k in _BLOCK_WSPECS
                  else v) for k, v in lp.items()}
    hnb = _norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_bias"))
    if meshed:
        hnb = shard_hint(hnb, _ROWS)
    q, k, v = hnb @ lp["wq"], hnb @ lp["wk"], hnb @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if meshed:
        ms = mesh_axis_size("model")
        head_ax = "model" if (ms is not None and h % ms == 0
                              and cache is None) else None
        kv_head_ax = "model" if (head_ax and hkv % ms == 0) else None
        q = split_heads(q, h, hd, head_ax)
        k = split_heads(k, hkv, hd, kv_head_ax)
        v = split_heads(v, hkv, hd, kv_head_ax)
    else:
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
    if cfg.pos_embed == "rope":
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    rows = torch.arange(b, device=x.device)

    page_table = None
    if cache is not None and len(cache) == 3:
        # paged decode (s == 1): each row writes its token at
        # (table[pos // ps], pos % ps); rows with no page mapped there
        # (inactive slots) write to the trash page
        kp, vp, page_table = cache
        ps = kp.shape[1]
        pids = page_table[rows, q_offset // ps]
        kp[pids, q_offset % ps] = k[:, 0].to(kp.dtype)
        vp[pids, q_offset % ps] = v[:, 0].to(vp.dtype)
        k, v = kp, vp
    elif cache is not None:
        ck, cv = cache
        cols = _qpos(q_offset, s, x.device)
        cols = cols if cols.dim() == 2 else cols[None].expand(b, s)
        write_rows(ck, rows[:, None], cols, k)
        write_rows(cv, rows[:, None], cols, v)
        k, v = ck, cv

    if torch.is_tensor(q_offset) and q_offset.dim() == 1:
        # ragged per-slot positions: at s == 1 the kv_len mask is the
        # causal constraint; s > 1 is bucketed prefill, causal per row
        attn = attention(q, k, v, impl=cfg.attn_impl, causal=s > 1,
                         window=cfg.window, kv_len=kv_len,
                         q_offset=q_offset, page_table=page_table)
    else:
        attn = attention(q, k, v, impl=cfg.attn_impl, causal=True,
                         window=cfg.window, q_offset=q_offset,
                         kv_len=kv_len)
    if meshed:
        attn_out = shard_hint(merge_heads(attn, head_ax) @ lp["wo"], _ROWS)
    else:
        attn_out = attn.reshape(b, s, h * hd) @ lp["wo"]
    if cfg.parallel_block:
        # Command-R: attention and FFN read the same normed input
        return x + cfg.residual_scale * (attn_out + _mlp(cfg, lp, hnb))
    x = x + cfg.residual_scale * attn_out
    h2 = _norm(cfg, x, lp["mlp_norm"], lp.get("mlp_norm_bias"))
    if not meshed:
        return x + cfg.residual_scale * _mlp(cfg, lp, h2)
    mlp_out = shard_hint(_mlp(cfg, lp, shard_hint(h2, _ROWS)), _ROWS)
    return x + cfg.residual_scale * mlp_out


def _mlp(cfg, lp, h):
    """The block's FFN: the expert FFN over all B * S tokens of the call
    (capacity and drops are per call, as in the reference), a GELU MLP
    with biases, or SwiGLU / GeGLU."""
    if cfg.is_moe:
        b, s, d = h.shape
        moe_params = {"router": lp["router"], "wi_gate": lp["moe_wi_gate"],
                      "wi_up": lp["moe_wi_up"], "wo": lp["moe_wo"]}
        return moe_ffn(h.reshape(b * s, d), moe_params,
                       num_experts=cfg.num_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor).reshape(b, s, d)
    if cfg.mlp_act == "gelu":
        return gelu_mlp(h, lp["wi"], lp["bi"], lp["wo_mlp"], lp["bo"])
    fn = geglu if cfg.mlp_act == "geglu" else swiglu
    return fn(h, lp["wi_gate"], lp["wi_up"], lp["wo_mlp"])


def _embed(cfg, params, tokens):
    """tokens (B, S), or (B, n_q, S) with the codebooks' embeddings summed
    (the EnCodec stub of the reference)."""
    emb = params["embed"]
    if cfg.n_codebooks > 1:
        x = sum(embed_rows(emb[q], tokens[:, q])
                for q in range(cfg.n_codebooks))
    else:
        x = embed_rows(emb, tokens)
    return (x * cfg.embed_scale).to(cfg.cdtype)


def _unembed(cfg, params, x):
    """(B, S, V) logits, or (B, n_q, S, V) for a multi-codebook model."""
    if cfg.n_codebooks > 1:
        head = _head(cfg, params)
        if is_dtensor(x):
            # one product per codebook: DTensor has no rule for the
            # einsum's batched form
            logits = torch.stack([x @ head[q] for q in
                                  range(cfg.n_codebooks)], dim=1)
        else:
            logits = torch.einsum("bsd,qdv->bqsv", x, head)
        logits = shard_hint(logits, ("batch", None, None, "model"))
    else:
        logits = shard_hint(x @ _head(cfg, params),
                            ("batch", None, "model"))
    return logits * cfg.logit_scale


def _head(cfg, params):
    """The cast unembedding matrix, a DTensor's FSDP dim gathered."""
    return gather_fsdp(params["head"], (None,) * (cfg.n_codebooks > 1)
                       + ("fsdp", "model"))


def _sin_table(cfg, pos, dtype):
    """Sinusoidal embeddings of positions `pos` (any shape), (..., d)."""
    d = cfg.d_model
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _cos_sin(cfg, positions):
    """RoPE tables for `positions` ((S,), (B, S), or M-RoPE's (3, B, S));
    None for sinusoidal models, whose positions enter at the embedding."""
    if cfg.pos_embed != "rope":
        return None, None
    if cfg.mrope_sections is not None:
        return mrope_cos_sin(positions, cfg.hd, cfg.mrope_sections,
                             cfg.rope_base, cfg.cdtype)
    return rope_cos_sin(positions, cfg.hd, cfg.rope_base, cfg.cdtype)


def _positions(cfg, x, pos0, positions):
    """Add the sinusoidal embeddings of positions pos0 + arange(s) (pos0 a
    scalar or a (B,) vector) to the embedded x, and give the RoPE tables
    of `positions`, by default those positions (on all three M-RoPE
    axes)."""
    b, s = x.shape[0], x.shape[1]
    pos_ids = _qpos(pos0, s, x.device)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sin_table(cfg, pos_ids if pos_ids.dim() == 2
                           else pos_ids[None], x.dtype)
    if positions is None:
        if cfg.mrope_sections is not None:
            p = pos_ids.expand(b, s)
            positions = torch.stack([p, p, p])
        else:
            positions = pos_ids
    return x, _cos_sin(cfg, positions)


def _hidden(params, tokens, cfg: TransformerConfig, positions=None):
    """Embeddings -> blocks -> final norm, from cast params."""
    x = _embed(cfg, params, tokens)
    meshed = is_dtensor(x)
    if meshed:
        x = shard_hint(x, _ROWS)
    x, (cos, sin) = _positions(cfg, x, 0, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            # no dropout anywhere, so no RNG state to stash and replay
            x = checkpoint(_block, cfg, x, _layer(params, i), cos, sin,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(cfg, x, _layer(params, i), cos, sin)
        if meshed:
            x = shard_hint(x, _ROWS)
    return _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))


def forward(params, tokens, cfg: TransformerConfig, positions=None):
    """tokens (B, S) int, or (B, n_q, S) for multi-codebook -> logits
    (B, S, V) (or (B, n_q, S, V))."""
    params = cast_params(params, cfg)
    return _unembed(cfg, params, _hidden(params, tokens, cfg, positions))


def loss_fn(params, batch, cfg: TransformerConfig):
    """Mean next-token cross-entropy.  batch: {tokens, labels[,
    positions]}.  With cfg.loss_chunk > 0 dividing the sequence (and one
    codebook), the (B, S, V) logits are never materialised: the xent runs
    chunk by chunk."""
    labels = batch["labels"]
    params = cast_params(params, cfg)
    x = _hidden(params, batch["tokens"], cfg, batch.get("positions"))
    if cfg.loss_chunk and cfg.n_codebooks == 1 \
            and labels.shape[-1] % cfg.loss_chunk == 0:
        return chunked_lm_loss(x, _head(cfg, params), labels,
                               chunk=cfg.loss_chunk,
                               logit_scale=cfg.logit_scale)
    return softmax_xent(_unembed(cfg, params, x), labels).mean()


# --------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               pad_to: int = 128, device="cuda") -> dict:
    """KV cache in model layout (L, B, M, Hkv, dh), M rounded up to a
    multiple of `pad_to`; positions >= kv_len are masked downstream."""
    dtype = dtype or cfg.cdtype
    m = -(-max_len // pad_to) * pad_to
    shape = (cfg.n_layers, batch, m, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params, cache, tokens, cfg: TransformerConfig,
                positions=None, last_idx=None):
    """One decode step: tokens (B, S_new) (1 for decode, > 1 for prefill),
    or (B, n_q, S_new) for multi-codebook.  cache["pos"] is a scalar or a
    (B,) per-row vector.  Returns (logits (B, V) or (B, n_q, V), cache)
    with k/v written in place and pos advanced.

    `last_idx`: optional (B,) index of the position whose logits to return
    (ragged bucketed prefill reads row b at prompt_len - 1; one codebook
    only, as in the reference)."""
    params = cast_params(params, cfg)
    x = _embed(cfg, params, tokens)
    b, s = x.shape[0], x.shape[1]
    pos0 = cache["pos"]
    x, (cos, sin) = _positions(cfg, x, pos0, positions)
    kv_len = pos0 + s
    for i in range(cfg.n_layers):
        x = _block(cfg, x, _layer(params, i), cos, sin, q_offset=pos0,
                   cache=(cache["k"][i], cache["v"][i]), kv_len=kv_len)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    new = {"k": cache["k"], "v": cache["v"], "pos": pos0 + s}
    if last_idx is not None:
        if cfg.n_codebooks != 1:
            raise ValueError("last_idx requires a single codebook")
        # gather each row's last real position before the unembed
        x = x.gather(1, last_idx.long()[:, None, None].expand(b, 1,
                                                              x.shape[2]))
    logits = _unembed(cfg, params, x[:, -1:])
    return (logits[:, :, -1] if cfg.n_codebooks > 1 else logits[:, -1]), new


def init_paged_pool(cfg: TransformerConfig, pool_pages: int, page_size: int,
                    dtype=None, device="cuda"):
    """Paged KV pool (L, P+1, page_size, Hkv, dh); page P is the trash
    page, pages 0..P-1 are allocatable."""
    dtype = dtype or cfg.cdtype
    shape = (cfg.n_layers, pool_pages + 1, page_size, cfg.n_kv_heads,
             cfg.hd)
    return torch.zeros(shape, dtype=dtype, device=device)


def paged_decode_step(params, cache, tokens, cfg: TransformerConfig):
    """One paged decode step: tokens (B, 1).  cache holds the "kp"/"vp"
    pools (L, P+1, ps, Hkv, dh), "ptab" (B, max_pages) int32 and "pos"
    (B,).  Returns (logits (B, V), cache) with the pools written in place;
    positions, RoPE / M-RoPE and sinusoidal embeddings follow decode_step
    exactly, so paged == dense."""
    params = cast_params(params, cfg)
    if cfg.n_codebooks != 1:
        raise ValueError("paged decode takes single-codebook token streams")
    x = _embed(cfg, params, tokens)
    if x.shape[1] != 1:
        raise ValueError("paged_decode_step decodes one token per row")
    pos0 = cache["pos"]
    x, (cos, sin) = _positions(cfg, x, pos0, None)
    kv_len = pos0 + 1
    ptab = cache["ptab"]
    for i in range(cfg.n_layers):
        x = _block(cfg, x, _layer(params, i), cos, sin, q_offset=pos0,
                   cache=(cache["kp"][i], cache["vp"][i], ptab),
                   kv_len=kv_len)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    return _unembed(cfg, params, x)[:, -1], {**cache, "pos": pos0 + 1}
