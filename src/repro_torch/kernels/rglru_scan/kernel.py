"""Load and launch the RG-LRU scan CUDA kernels from `csrc/rglru_scan.cu`:
the forward (B4) and its backward, a reverse walk.

The source has a plain C interface; `kernels/_build.py` compiles it with
`nvcc` for `sm_90a` at first use and loads it with `ctypes`.  Nothing here
runs at import, so the CPU tests import this module freely.  A launch that
CUDA refuses raises with its error code.  `rglru_scan_fwd.launches` and
`rglru_scan_bwd.launches` count each kernel's launches.
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
    lib.rglru_scan_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.rglru_scan_bwd_launch.restype = i


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",
                  _declare)


def copy_path(*ts) -> str:
    """The path that fills a kernel's shared-memory ring for these
    tensors (a and x forward; a, h and g backward): "tma" where each row
    of D elements is a whole number of 16-byte units and every base is
    16-byte aligned (TMA's rule), else "cp.async" (4-byte copies, float32
    only: `rglru_scan_fwd` widens a bfloat16 layout that TMA cannot take
    to float32 first)."""
    if (ts[0].shape[-1] * ts[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in ts)):
        return "tma"
    return "cp.async"


def _check(names, ts, dtypes):
    """The wrappers' shared checks: one (B, S, D) shape, contiguous, on
    one CUDA device, bases aligned to the element size."""
    shape = ts[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in ts):
        raise ValueError(f"rglru scan takes {', '.join(names)} of one "
                         f"(B, S, D) shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype not in dtypes for t in ts):
        raise TypeError(f"rglru scan kernel takes {', '.join(names)} as "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"rglru scan kernel needs {', '.join(names)} on "
                         f"one CUDA device, got {[t.device for t in ts]}")
    for name, t in zip(names, ts):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} must start aligned to its element "
                             f"size (the copies are whole elements)")


def rglru_scan_fwd(a, x):
    """B4.  a, x (B, S, D) contiguous CUDA tensors of one dtype (float32
    or bfloat16).  Returns h (B, S, D) in x's dtype, h_t = a_t h_{t-1} +
    x_t with an f32 carry from h0 = 0."""
    _check(("a", "x"), (a, x), _DTYPES)
    if a.dtype != x.dtype:
        raise TypeError(f"rglru scan kernel takes a and x both float32 or "
                        f"both bfloat16, got {a.dtype} and {x.dtype}")
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


def rglru_scan_bwd(a, h, g):
    """The backward of B4.  a (B, S, D), h the forward's float32 carry,
    g the output's gradient: contiguous CUDA tensors, a and g float32 or
    bfloat16.  Returns (da in a's dtype, dx in g's dtype), the reverse
    walk dh_t = g_t + a_{t+1} dh_{t+1}, dx = dh, da_t = dh_t h_{t-1} in
    float32.  The kernel takes float32: bfloat16 a and g are widened
    (exactly) and the gradients rounded once at the end, as the plain
    version rounds them."""
    _check(("a", "h", "g"), (a, h, g), _DTYPES)
    if h.dtype != torch.float32:
        raise TypeError(f"h must be the forward's float32 carry, got "
                        f"{h.dtype}")
    if a.dtype != torch.float32 or g.dtype != torch.float32:
        da, dx = rglru_scan_bwd(a.float(), h, g.float())
        return da.to(a.dtype), dx.to(g.dtype)
    b, s, d = g.shape
    da, dx = torch.empty_like(a), torch.empty_like(g)
    if dx.numel() == 0:
        return da, dx
    lib = LIBRARY.load()
    err = lib.rglru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
        dx.data_ptr(), b, s, d, int(copy_path(a, h, g) == "tma"),
        torch.cuda.current_stream(g.device).cuda_stream)
    raise_on(err, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return da, dx


rglru_scan_bwd.launches = 0
