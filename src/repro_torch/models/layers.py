"""Shared layers of the decoder LMs in PyTorch: norms, RoPE, attention,
MLPs.

`attention` dispatches by shape, never by a switch: a one-row query with a
`kv_len` and no window goes to the decode-attention kernels (dense, or
paged when a page table is given); a full-sequence call (q_offset the
Python int 0, no window, no `kv_len`, Sq == Skv > 1) goes to the
flash-attention kernel, under the reference's own condition for it.  Each
wrapper runs its CUDA kernel for CUDA tensors and the plain version for
CPU tensors.  Everything else (the engine's ragged prefill, windows) runs
`attention_ref`, or `attention_chunked` (the reference's online-softmax
over KV blocks, a plain function) when the caller asks for
`impl="chunked"`: the RG-LRU model's windowed prefill goes there, and its
ring decode (one row, `kv_len`, no window) to the dense decode kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.hints import is_dtensor
from repro_torch.kernels._boundary import heads_local_map
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * weight + bias).to(dtype)


def rope_cos_sin(positions, head_dim: int, base: float = 10000.0,
                 dtype=torch.float32):
    """positions (..., S) -> cos/sin (..., S, head_dim/2)."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions.device) / head_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def mrope_cos_sin(positions_thw, head_dim: int, sections=(16, 24, 24),
                  base: float = 10000.0, dtype=torch.float32):
    """Qwen2-VL multimodal RoPE: positions_thw (3, B, S) for (t, h, w);
    the frequency slots split into `sections` (t/h/w) summing to
    head_dim/2.  Returns cos/sin (B, S, head_dim/2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {head_dim // 2}")
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions_thw.device)
                          / head_dim))
    cos_all, sin_all = [], []
    lo = 0
    for i, sec in enumerate(sections):
        ang = positions_thw[i][..., None].float() * inv[lo:lo + sec]
        cos_all.append(torch.cos(ang))
        sin_all.append(torch.sin(ang))
        lo += sec
    return (torch.cat(cos_all, -1).to(dtype),
            torch.cat(sin_all, -1).to(dtype))


def apply_rope(x, cos, sin):
    """x (B, S, H, Dh); cos/sin (B, S, Dh/2) or (S, Dh/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def repeat_kv(k, n_rep: int):
    """(B, S, Hkv, Dh) -> (B, S, Hkv * n_rep, Dh)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _qpos(q_offset, sq: int, device):
    """Absolute query positions: (B, Sq) for a (B,) offset vector, (Sq,)
    for a scalar offset (an int or a 0-d tensor)."""
    ar = torch.arange(sq, device=device)
    if torch.is_tensor(q_offset) and q_offset.dim() == 1:
        return q_offset[:, None] + ar[None]
    return ar + q_offset


def _qk_mask(qpos, kpos, causal: bool, window):
    """Causal and local-window visibility, shape qpos.shape + kpos.shape."""
    mask = torch.ones(qpos.shape + kpos.shape, dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window is not None:
        mask &= kpos > qpos[..., None] - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window=None, q_offset=0,
                  kv_len=None):
    """Reference attention.  q (B, Sq, H, Dh), k/v (B, Skv, Hkv, Dh).

    `q_offset`: absolute position of q[:, 0], a scalar or a (B,) vector.
    `window`: local attention span.  `kv_len`: valid KV length, scalar or
    (B,).  GQA groups query heads in the product; K/V are never repeated.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = (q * dh ** -0.5).reshape(b, sq, hkv, g, dh)
    # f32 accumulation: products of bf16 values are exact in f32, so this
    # is the reference's preferred_element_type=f32 product
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    kpos = torch.arange(skv, device=q.device)
    mask = _qk_mask(_qpos(q_offset, sq, q.device), kpos, causal, window)
    mask = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 1:
            mask = mask & (kpos < kv_len[:, None, None, None, None])
        else:
            mask = mask & (kpos < kv_len)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def attention_chunked(q, k, v, *, causal: bool = True, window=None,
                      q_offset=0, kv_len=None, kv_block: int = 512):
    """Online-softmax attention over KV blocks of `kv_block` positions
    (the flash recurrence, in f32): peak memory per block is (B, H, Sq,
    kv_block) instead of (B, H, Sq, Skv).  Arguments as `attention_ref`;
    Skv need not be a multiple of `kv_block` (the tail block is padded and
    masked)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k, v = repeat_kv(k, h // hkv), repeat_kv(v, h // hkv)
    if skv % kv_block:
        pad = kv_block - skv % kv_block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float() * dh ** -0.5
    qpos = _qpos(q_offset, sq, q.device)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 1 and qpos.dim() == 1:
            qpos = qpos.expand(b, sq)     # a per-row mask for (B,) kv_len
    acc = torch.zeros(b, h, sq, dh, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros(b, h, sq, device=q.device)
    for i in range(k.shape[1] // kv_block):
        kc = k[:, i * kv_block:(i + 1) * kv_block].float()
        vc = v[:, i * kv_block:(i + 1) * kv_block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc)
        kpos = i * kv_block + torch.arange(kv_block, device=q.device)
        mask = _qk_mask(qpos, kpos, causal, window)
        if kv_len is not None:
            mask &= kpos < (kv_len[:, None, None] if kv_len.dim() == 1
                            else kv_len)
        mask &= kpos < skv
        mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(v.dtype)


def attention(q, k, v, *, impl: str = "ref", page_table=None,
              causal: bool = True, window=None, q_offset=0, kv_len=None):
    """Dispatch by shape.  With `page_table`, k/v are (P+1, ps, Hkv, dh)
    pools and the call is a paged decode step.  `impl="chunked"` (the
    config's `attn_impl`) sends the multi-row calls that no kernel takes
    to `attention_chunked`, as the reference's `attention` does; any
    other value leaves them to `attention_ref`."""
    if page_table is not None:
        if q.shape[1] != 1 or window is not None or kv_len is None:
            raise ValueError("paged attention is one-row decode with "
                             "kv_len and no window")
        return paged_decode_attention(q, k, v, page_table, kv_len)
    if q.shape[1] == 1 and window is None and kv_len is not None:
        return decode_attention(q, k, v, kv_len)
    if window is None and kv_len is None and isinstance(q_offset, int) \
            and q_offset == 0 and 1 < q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, causal=causal)
    if is_dtensor(q):
        # no kernel takes this call: the plain versions on each rank's
        # heads (positions and lengths plain, the same on every rank)
        return heads_local_map(
            lambda a, b, c: attention(a, b, c, impl=impl, causal=causal,
                                      window=window, q_offset=q_offset,
                                      kv_len=kv_len), q, k, v, head_dim=2)
    if impl == "chunked" and q.shape[1] > 1:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len)


def swiglu(x, wi_gate, wi_up, wo):
    """LLaMA-style gated MLP: (B,S,D) x (D,F)x2 x (F,D)."""
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def geglu(x, wi_gate, wi_up, wo):
    """Gemma-style gated MLP, tanh-approximate GELU on the gate."""
    return (F.gelu(x @ wi_gate, approximate="tanh") * (x @ wi_up)) @ wo


def gelu_mlp(x, wi, bi, wo, bo):
    """Plain GELU MLP with biases (MusicGen), tanh-approximate GELU."""
    return F.gelu(x @ wi + bi, approximate="tanh") @ wo + bo
