"""Plain PyTorch version of the flash-attention kernel: the oracle the CPU
tests hold against the JAX package and `chip_smoke.py` holds the CUDA
kernel against, what the wrapper runs for CPU tensors, and the formula the
backward pass differentiates.

Same semantics as the reference oracle `attention_reference`: head-major
layout, f32 math, scale dh**-0.5, GQA by repeating each kv head over its
group, and a causal mask aligned bottom-right (`tril(k=Skv-Sq)`), which
is the kernel's top-left mask when Sq == Skv.
"""
from __future__ import annotations

import torch


def attention_reference(q, k, v, causal: bool = True):
    """q (B, H, Sq, dh); k, v (B, Hkv, Skv, dh).  Returns (B, H, Sq, dh)
    in q's dtype."""
    h, sq, dh = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * dh ** -0.5
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
