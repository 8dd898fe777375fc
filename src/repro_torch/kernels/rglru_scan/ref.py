"""Plain PyTorch version of the RG-LRU scan kernel and of its backward:
the oracles the CPU tests hold against the JAX package and
`chip_smoke.py` holds the CUDA kernels against, and what the autograd
wrapper runs for CPU tensors.

Same semantics as the reference's sequential oracle
`rglru_scan_reference`: h_t = a_t * h_{t-1} + x_t along axis 1, h0 = 0,
an f32 carry, one rounding for the product and one for the sum (two
separate ops, never fused), output in x's dtype.  The loop walks the
steps of `unbind`, so autograd through it hands back each step's
gradient as it is (a per-step select would add it into zeros, and
-0.0 + 0.0 is +0.0): `rglru_scan_backward_reference` equals that
autograd bitwise, signed zeros included.
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
    for at, xt in zip(a.unbind(1), x.unbind(1)):
        h = at.float() * h + xt.float()
        hs.append(h)
    if not hs:
        return torch.empty_like(x)
    return torch.stack(hs, 1).to(x.dtype)


def rglru_scan_backward_reference(a, h, g):
    """The VJP of `rglru_scan_reference` (h0 = 0) as an explicit reverse
    walk in f32.  a (B, S, D); h the forward's f32 carry (its output for
    f32 x); g the output's gradient.  Returns (da in a's dtype, dx in g's
    dtype):

      dh_{S-1} = g_{S-1},  dh_t = g_t + a_{t+1} * dh_{t+1}
      dx_t = dh_t,         da_t = dh_t * h_{t-1},  h_{-1} = 0

    each product and each sum rounded once, so da_0 = dh_0 * 0.0 keeps
    dh_0's sign."""
    s = a.shape[1]
    if s == 0:
        return torch.empty_like(a), torch.empty_like(g)
    a32, g32 = a.float(), g.float()
    dh = [None] * s
    dh[s - 1] = g32[:, s - 1]
    for t in range(s - 2, -1, -1):
        dh[t] = g32[:, t] + a32[:, t + 1] * dh[t + 1]
    dh = torch.stack(dh, 1)
    h32 = h.float()
    hprev = torch.cat([torch.zeros_like(h32[:, :1]), h32[:, :-1]], 1)
    return (dh * hprev).to(a.dtype), dh.to(g.dtype)
