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

A DTensor goes through `_boundary.heads_local_map` (each rank's heads),
or, where q's sequence is sharded over "model" and K/V are whole (heads
that do not divide the axis), `_boundary.query_local_map`: each rank runs
its query rows at `q_offset` = its first row's position.  A fake tensor
launches nothing and reports the kernel's FLOPs and bytes
(`_boundary.COUNTS["flash_attention"]`: the visible pairs at the call's
offset, counted exactly; inside a query split also every model rank's
count at its own offset).  `flash_attention.offset_launches` counts the
launches of a causal call at an offset or with Sq != Skv (a query
slice), which `flash_attention.launches` counts too.
"""
from __future__ import annotations

import torch

from .. import _boundary
from . import kernel
from .ref import attention_reference


def visible_pairs(sq: int, skv: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the kernel computes: row i sees keys
    0 .. min(Skv, i + q_offset + 1) - 1 under the causal mask, all Skv
    otherwise."""
    if not causal:
        return sq * skv
    full = min(max(skv - q_offset, 0), sq)     # rows below the last key
    return full * (q_offset + 1) + full * (full - 1) // 2 + \
        (sq - full) * skv


def fake_flops(b, h, sq, skv, dh, causal, q_offset) -> int:
    """4 dh FLOPs (two products) per visible pair, per (row, head)."""
    return 4 * b * h * dh * visible_pairs(sq, skv, causal, q_offset)


def _fake_fwd(q, k, v, causal, q_offset):
    """The kernel's output shape (B, H, Sq, dh), and its count."""
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    out = _boundary.fake_like(q, (b, sq, h, dh)).transpose(1, 2)
    split = _boundary.query_split()
    by_rank = None if split is None else [
        fake_flops(b, h, sq, skv, dh, causal, q_offset + d)
        for d in split]
    _boundary.report("flash_attention",
                     fake_flops(b, h, sq, skv, dh, causal, q_offset),
                     _boundary.nbytes(q, k, v, out), by_rank)
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, q_offset
        if _boundary.is_fake(q):
            return _fake_fwd(q, k, v, causal, q_offset)
        if q.device.type == "cpu":
            return attention_reference(q, k, v, causal=causal,
                                       q_offset=q_offset)
        out = kernel.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset)
        flash_attention.launches += 1
        if causal and (q_offset or q.shape[2] != k.shape[2]):
            flash_attention.offset_launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*qkv, causal=ctx.causal,
                                      q_offset=ctx.q_offset)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    layout: str = "bshd"):
    """layout "bshd": q (B, S, H, dh), k/v (B, S, Hkv, dh); "bhsd": head
    major.  Returns the input's layout.  Causal: key j is masked for
    query row i iff j > i + q_offset, with Sq + q_offset <= Skv (q's rows
    are a slice of the keys' positions; Sq == Skv at offset 0 is the
    whole sequence)."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout {layout!r}: 'bshd' or 'bhsd'")
    seq_dim = 1 if layout == "bshd" else 2
    if _boundary.is_dtensor(q):
        def local(a, b, c, off=0):
            return flash_attention(a, b, c, causal=causal,
                                   q_offset=q_offset + off, layout=layout)
        if _boundary.length_sharded(q, seq_dim):
            return _boundary.query_local_map(local, q, k, v,
                                             seq_dim=seq_dim)
        return _boundary.heads_local_map(
            local, q, k, v, head_dim=2 if layout == "bshd" else 1)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if causal and (q_offset < 0 or q.shape[2] + q_offset > k.shape[2]):
        raise ValueError(f"causal flash attention needs 0 <= q_offset and "
                         f"Sq + q_offset <= Skv, got Sq {q.shape[2]}, "
                         f"q_offset {q_offset}, Skv {k.shape[2]}")
    out = _Flash.apply(q, k, v, causal, int(q_offset))
    return out.transpose(1, 2) if layout == "bshd" else out


flash_attention.launches = 0
flash_attention.offset_launches = 0
