"""Flash attention (kernel B3) as a `torch.autograd.Function`.

Forward: a CPU tensor runs the plain version (`ref.attention_reference`);
a CUDA tensor launches the CUDA kernel or raises.  There is no switch and
no fallback: the tensor's device decides.  `flash_attention.launches`
counts kernel launches.

Backward: the JAX package has no backward kernel.  Its custom_vjp
(`_flash_bwd`) differentiates the oracle `attention_reference`, and so
does this one: it recomputes the plain formula from the saved q, k, v
under `torch.enable_grad()` and takes its vector-Jacobian product.  That
is the reference's own backward, not a stand-in for the forward kernel;
a hand-written backward kernel is later work.

A DTensor goes through `_boundary.heads_local_map` (each rank's heads);
a fake tensor launches nothing and reports the kernel's FLOPs and bytes
(`_boundary.COUNTS["flash_attention"]`).
"""
from __future__ import annotations

import torch

from .. import _boundary
from . import kernel
from .ref import attention_reference


def _fake_fwd(q, k, v, causal):
    """The kernel's output shape (B, H, Sq, dh), and its count: 4 B H Sq
    Skv dh FLOPs (two products), half of them under a causal mask."""
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    flops = 4 * b * h * sq * skv * dh // (2 if causal else 1)
    out = _boundary.fake_like(q, (b, sq, h, dh)).transpose(1, 2)
    _boundary.report("flash_attention", flops,
                     _boundary.nbytes(q, k, v, out))
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if _boundary.is_fake(q):
            return _fake_fwd(q, k, v, causal)
        if q.device.type == "cpu":
            return attention_reference(q, k, v, causal=causal)
        out = kernel.flash_attention_fwd(q, k, v, causal=causal)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*qkv, causal=ctx.causal)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True, layout: str = "bshd"):
    """layout "bshd": q (B, S, H, dh), k/v (B, S, Hkv, dh); "bhsd": head
    major.  Returns the input's layout.  Causal attention needs Sq == Skv:
    the kernel's mask is top-left and the oracle's bottom-right, and the
    two agree only there."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout {layout!r}: 'bshd' or 'bhsd'")
    if _boundary.is_dtensor(q):
        return _boundary.heads_local_map(
            lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                            layout=layout),
            q, k, v, head_dim=2 if layout == "bshd" else 1)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal flash attention needs Sq == Skv, got "
                         f"{q.shape[2]} and {k.shape[2]}")
    out = _Flash.apply(q, k, v, causal)
    return out.transpose(1, 2) if layout == "bshd" else out


flash_attention.launches = 0
