"""Load and launch the flash-attention forward CUDA kernel (B3) from
`csrc/flash_attention.cu`.

The source has a plain C interface; `kernels/_build.py` compiles it with
`nvcc` for `sm_90a` at first use and loads it with `ctypes`.  Nothing here
runs at import, so the CPU tests import this module freely.  A launch that
CUDA refuses raises with its error code.  The bf16 kernel's TMA tensor
maps are encoded on the host at each call from pointers, shapes and
strides alone, so a call never synchronises.

Instances: dh 64, 128 and 160.  A head dim below 64 (the reduced configs'
8, 12, 16 and 20) is zero-padded to the 64 instance and run with its own
softmax scale (`_head_dim.py`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, raise_on
from .._head_dim import instance_head_dim, pad_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 160)


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, ctypes.c_float, p, i]
    lib.flash_attention_launch.restype = i


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" /
                  "flash_attention.cu", _declare)


def _check(q, k, v):
    """Raise on what the kernels cannot take.  The bf16 kernel reads q, k
    and v through TMA tensor maps, the f32 kernel with 16-byte loads; both
    need, for each tensor:
      - the head dim contiguous (stride 1);
      - the base address 16-byte aligned;
      - every other stride (batch, head, position) a positive multiple of
        16 bytes below 2**40 bytes, where that dim has more than one entry
        (`_strides` passes a harmless 16 bytes for size-1 dims)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {q.shape[-1]}")
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head dim must be contiguous (strides "
                             f"{t.stride()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base address must be 16-byte aligned")
        for n, s in zip(t.shape[:-1], t.stride()[:-1]):
            if n > 1 and not (0 < s * size < 2 ** 40 and s * size % 16 == 0):
                raise ValueError(f"{name}: strides must be positive "
                                 f"multiples of 16 bytes (strides "
                                 f"{t.stride()}, {size}-byte elements)")


def _strides(t):
    """Element strides of (batch, head, position), 16 bytes for a dim of
    one entry (never stepped over; a tensor map still needs a legal one)."""
    vec = 16 // t.element_size()
    return [s if n > 1 else vec for n, s in zip(t.shape[:3], t.stride()[:3])]


def flash_attention_fwd(q, k, v, *, causal: bool, q_offset: int = 0):
    """B3.  q (B, H, Sq, dh); k, v (B, Hkv, Skv, dh), any strides with the
    head dim contiguous (a head-major view of the (B, S, H, dh) model
    layout goes in as it is).  Causal means key position <= query
    position + q_offset (q's rows sit at q_offset, q_offset + 1, ... of
    the keys' positions).  Returns a (B, Sq, H, dh)-contiguous tensor viewed as
    (B, H, Sq, dh), in q's dtype.  A head dim below 64 runs on the 64
    instance, zero-padded, at its own scale dh**-0.5."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, dh) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if sq == 0 or skv == 0:
        raise ValueError("flash attention needs Sq > 0 and Skv > 0")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    run_dh = instance_head_dim(dh, _HEAD_DIMS, "flash attention")
    q, k, v = (pad_head_dim(t, run_dh) for t in (q, k, v))
    _check(q, k, v)
    lib = LIBRARY.load()
    out = torch.empty(b, sq, h, run_dh, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in _strides(t)))
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, h // hkv, sq, skv, run_dh, _DTYPES[q.dtype], int(causal),
        dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
        int(q_offset))
    raise_on(err, "flash_attention")
    if run_dh != dh:
        out = out[..., :dh].transpose(1, 2).contiguous().transpose(1, 2)
    return out
