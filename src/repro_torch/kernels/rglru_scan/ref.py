"""Plain PyTorch version of the RG-LRU scan kernel: the oracle the CPU
tests hold against the JAX package and `chip_smoke.py` holds the CUDA
kernel against, what the wrapper runs for CPU tensors, and the formula
the backward pass differentiates.

Same semantics as the reference's sequential oracle
`rglru_scan_reference`: h_t = a_t * h_{t-1} + x_t along axis 1, h0 = 0,
an f32 carry, one rounding for the product and one for the sum (two
separate ops, never fused), output in x's dtype.
"""
from __future__ import annotations

import torch


def rglru_scan_reference(a, x, h0=None):
    """a, x (B, S, D); h0 optional (B, D) f32.  Returns (B, S, D) in x's
    dtype."""
    b, s, d = x.shape
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    hs = []
    for t in range(s):
        h = a[:, t].float() * h + x[:, t].float()
        hs.append(h)
    if not hs:
        return torch.empty_like(x)
    return torch.stack(hs, 1).to(x.dtype)
