"""Load and launch the RG-LRU scan CUDA kernel (B4) from
`csrc/rglru_scan.cu`.

The source has a plain C interface; `kernels/_build.py` compiles it with
`nvcc` for `sm_90a` at first use and loads it with `ctypes`.  Nothing here
runs at import, so the CPU tests import this module freely.  A launch that
CUDA refuses raises with its error code.  `rglru_scan_fwd.launches` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, raise_on

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.rglru_scan_launch.restype = i


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",
                  _declare)


def copy_path(a, x) -> str:
    """The path that fills the kernel's shared-memory ring for these
    tensors: "tma" where each row of D elements is a whole number of
    16-byte units and a and x start 16-byte aligned (TMA's rule), else
    "cp.async" (4-byte copies, float32 only: `rglru_scan_fwd` widens a
    bfloat16 layout that TMA cannot take to float32 first)."""
    if (x.shape[-1] * x.element_size() % 16 == 0
            and a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0):
        return "tma"
    return "cp.async"


def rglru_scan_fwd(a, x):
    """B4.  a, x (B, S, D) contiguous CUDA tensors of one dtype (float32
    or bfloat16).  Returns h (B, S, D) in x's dtype, h_t = a_t h_{t-1} +
    x_t with an f32 carry from h0 = 0."""
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru scan takes a and x of one (B, S, D) shape, "
                         f"got {tuple(a.shape)} and {tuple(x.shape)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype:
        raise TypeError(f"rglru scan kernel takes a and x both float32 or "
                        f"both bfloat16, got {a.dtype} and {x.dtype}")
    if not x.is_cuda or a.device != x.device:
        raise ValueError(f"rglru scan kernel needs a and x on one CUDA "
                         f"device, got {a.device} and {x.device}")
    for name, t in (("a", a), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} must start aligned to its element "
                             f"size (the copies are whole elements)")
    path = copy_path(a, x)
    if path == "cp.async" and x.dtype == torch.bfloat16:
        # 4-byte copies cannot take 2-byte elements at any offset: scan the
        # exact float32 widening and round once to nearest even, which is
        # what the kernel's bf16 store does with the same f32 carry
        return rglru_scan_fwd(a.float(), x.float()).to(torch.bfloat16)
    b, s, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    err = lib.rglru_scan_launch(
        a.data_ptr(), x.data_ptr(), out.data_ptr(), b, s, d,
        _DTYPES[x.dtype], int(path == "tma"),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "rglru_scan")
    rglru_scan_fwd.launches += 1
    return out


rglru_scan_fwd.launches = 0
