"""The RG-LRU scan (kernel B4) as a `torch.autograd.Function`.

Forward: a CPU tensor runs the plain version (`ref.rglru_scan_reference`);
a CUDA tensor launches the CUDA kernel or raises.  Unlike the reference,
which picks the Pallas kernel through `scan_impl` and pads to 256 x 128
blocks, the port has no switch and no padding: the tensor's device
decides, and the kernel takes any (B, S, D).
`kernel.rglru_scan_fwd.launches` counts kernel launches.

Backward: the VJP of the sequential recurrence, a reverse walk
(`ref.rglru_scan_backward_reference` for CPU tensors, the CUDA kernel
`kernel.rglru_scan_bwd` for CUDA tensors, counted in
`rglru_scan_bwd.launches`) over the saved a and the forward's f32
carry h.  The reference's custom_vjp differentiates its associative-scan
oracle instead (`src/repro/kernels/rglru_scan/ops.py::_scan_bwd`); both
are the VJP of the same recurrence.  Where x is not f32 and a gradient is
wanted, the forward scans the exact f32 widening and rounds its output
once, which is what the kernel's own bf16 store gives, so the saved carry
is the unrounded one.

A DTensor goes through `_boundary.same_local_map` (each rank's channels:
the recurrence is elementwise over D); a fake tensor launches nothing and
reports the kernel's FLOPs and bytes (`_boundary.COUNTS["rglru_scan"]`,
`["rglru_scan_bwd"]`).
"""
from __future__ import annotations

import torch

from .. import _boundary
from . import kernel
from .ref import rglru_scan_backward_reference, rglru_scan_reference


def _scan(a, x):
    if _boundary.is_fake(x):
        out = _boundary.fake_like(x, x.shape)
        _boundary.report("rglru_scan", 2 * x.numel(),
                         _boundary.nbytes(a, x, out))
        return out
    if x.device.type == "cpu":
        return rglru_scan_reference(a, x)
    return kernel.rglru_scan_fwd(a.contiguous(), x.contiguous())


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        if not any(ctx.needs_input_grad):
            return _scan(a, x)
        h = (_scan(a, x) if x.dtype == torch.float32
             else _scan(a.float(), x.float()))
        ctx.save_for_backward(a, h)
        return h.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        if _boundary.is_fake(g):
            da, dx = (_boundary.fake_like(a, a.shape),
                      _boundary.fake_like(g, g.shape))
            _boundary.report("rglru_scan_bwd", 4 * g.numel(),
                             _boundary.nbytes(a, h, g, da, dx))
            return da, dx
        if g.device.type == "cpu":
            return rglru_scan_backward_reference(a, h, g)
        return kernel.rglru_scan_bwd(a.contiguous(), h, g.contiguous())


def rglru_scan(a, x):
    """h_t = a_t h_{t-1} + x_t along axis 1, h0 = 0.  a, x (B, S, D);
    returns x's dtype."""
    if _boundary.is_dtensor(x):
        # placed as x: a (computed beside x) follows it
        return _boundary.same_local_map(lambda xl, al: _Scan.apply(al, xl),
                                        x, a)
    return _Scan.apply(a, x)
