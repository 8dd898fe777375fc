"""Plain PyTorch version of the flash-attention kernel: the oracle the CPU
tests hold against the JAX package and `chip_smoke.py` holds the CUDA
kernel against, what the wrapper runs for CPU tensors, and the formula the
backward pass differentiates.

Same semantics as the reference oracle `attention_reference`: head-major
layout, f32 math, scale dh**-0.5, GQA by repeating each kv head over its
group, and a causal mask aligned bottom-right (`tril(k=Skv-Sq)`), which
is the kernel's top-left mask when Sq == Skv; with a `q_offset` the mask
is the kernel's at that offset (`tril(k=q_offset)`: key j is masked for
query row i iff j > i + q_offset), the reference's `attention_ref` at a
scalar offset.

`tiled_attention_reference` spells out the bf16 CUDA kernel's algorithm
in plain PyTorch, for the tests: nothing on the training path calls it.
"""
from __future__ import annotations

import math

import torch

# Query rows and keys per tile of the bf16 kernel: BQ = BK in
# csrc/flash_attention.cu.
BLOCK = 128


def attention_reference(q, k, v, causal: bool = True, q_offset=None):
    """q (B, H, Sq, dh); k, v (B, Hkv, Skv, dh); q_offset None (the
    bottom-right mask) or an int.  Returns (B, H, Sq, dh) in q's
    dtype."""
    h, sq, dh = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * dh ** -0.5
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(
            skv - sq if q_offset is None else q_offset)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def tiled_attention_reference(q, k, v, causal: bool = True,
                              q_offset: int = 0):
    """The bf16 kernel's algorithm.  q (B, H, Sq, dh); k, v (B, Hkv, Skv,
    dh); causal means key position <= query position + q_offset
    (top-left at the offset).  Returns (B, H, Sq, dh) in q's dtype.

    Rows are zero-padded to whole tiles, as TMA's out-of-bounds fill does.
    Per tile of BLOCK query rows: key tiles of BLOCK keys up to the
    diagonal (causal) or Skv; keys >= Skv and, causal, keys past the row
    masked to -inf from the first tile that holds a key past the tile's
    first row (the last tile only, at an offset that is a multiple of
    BLOCK; the last two otherwise); the running max m kept in raw
    scores and exp2 taken with scale * log2(e) folded in; P rounded to q's
    dtype before P V (the denominator sums the unrounded P); the division
    by the denominator at the end.  The kernel adds tile t - 1's P V
    before tile t's rescale, the same sum in the same order of tiles."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    c = torch.tensor(dh ** -0.5, dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    n_qt, n_kt = -(-sq // BLOCK), -(-skv // BLOCK)
    pad = (0, 0, 0, n_qt * BLOCK - sq)
    qp = torch.nn.functional.pad(q, pad).float()
    pad = (0, 0, 0, n_kt * BLOCK - skv)
    kp, vp = (torch.nn.functional.pad(t, pad).repeat_interleave(
        h // hkv, dim=1) for t in (k, v))
    out = torch.zeros(b, h, n_qt * BLOCK, dh, device=q.device)
    rows = torch.arange(BLOCK, device=q.device)[:, None]
    cols = torch.arange(BLOCK, device=q.device)
    for qt in range(n_qt):
        q0 = qt * BLOCK
        kend = min(skv, q0 + BLOCK + q_offset) if causal else skv
        n = -(-kend // BLOCK)
        mask_from = min(n - 1, (q0 + q_offset + 1) // BLOCK) if causal \
            else n - 1
        qt_ = qp[:, :, q0:q0 + BLOCK]
        m = torch.full((b, h, BLOCK), -torch.inf, device=q.device)
        l = torch.zeros(b, h, BLOCK, device=q.device)
        acc = torch.zeros(b, h, BLOCK, dh, device=q.device)
        for t in range(n):
            kt = slice(t * BLOCK, (t + 1) * BLOCK)
            s = qt_ @ kp[:, :, kt].float().transpose(-1, -2)
            if t >= mask_from:
                kpos = t * BLOCK + cols
                masked = kpos >= skv
                if causal:
                    masked = masked | (kpos > q0 + rows + q_offset)
                s = s.masked_fill(masked, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            ms = torch.where(m_new == -torch.inf, 0.0, m_new * c)
            alpha = torch.exp2(m * c - ms)
            p = torch.exp2(s * c - ms[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] \
                + p.to(q.dtype).float() @ vp[:, :, kt].float()
            m = m_new
        out[:, :, q0:q0 + BLOCK] = torch.where(
            l[..., None] > 0, acc / l[..., None], 0.0)
    return out[:, :, :sq].to(q.dtype)
