"""The RG-LRU scan (kernel B4) as a `torch.autograd.Function`.

Forward: a CPU tensor runs the plain version (`ref.rglru_scan_reference`);
a CUDA tensor launches the CUDA kernel or raises.  Unlike the reference,
which picks the Pallas kernel through `scan_impl` and pads to 256 x 128
blocks, the port has no switch and no padding: the tensor's device
decides, and the kernel takes any (B, S, D).
`kernel.rglru_scan_fwd.launches` counts kernel launches.

Backward: the reference's custom_vjp differentiates its associative-scan
oracle; this one differentiates the plain sequential formula, recomputed
from the saved a and x under `torch.enable_grad()`.  Both are the VJP of
the same recurrence.  The kernel is forward-only.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import rglru_scan_reference


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        if x.device.type == "cpu":
            return rglru_scan_reference(a, x)
        return kernel.rglru_scan_fwd(a.contiguous(), x.contiguous())

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        with torch.enable_grad():
            ax = [t.detach().requires_grad_() for t in (a, x)]
            out = rglru_scan_reference(*ax)
            return torch.autograd.grad(out, ax, g)


def rglru_scan(a, x):
    """h_t = a_t h_{t-1} + x_t along axis 1, h0 = 0.  a, x (B, S, D);
    returns x's dtype."""
    return _Scan.apply(a, x)
