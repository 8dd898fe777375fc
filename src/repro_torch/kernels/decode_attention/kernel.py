"""Load and launch the decode-attention CUDA kernels (B1 dense, B2 paged)
from `csrc/decode_attention.cu`.

The source has a plain C interface; `kernels/_build.py` compiles it with
`nvcc` for `sm_90a` at first use and loads it with `ctypes`.  Nothing here
runs at import, so the CPU tests import this module freely.  A launch that
CUDA refuses raises with its error code.

One call launches two device kernels: the split kernel, one CTA per
(split of a fixed number of positions, kv head, row), and the merge, one
CTA per (query head, row).  The wrapper allocates their f32 workspace
with `torch.empty`, at the size the source's `decode_attention_workspace`
gives; the number of splits comes from shapes only, never from kv_len, so
nothing is read back from the card.

Instances: dh 64, 128, 160 and 256.  A head dim below 64 (the reduced
configs' 8, 12, 16 and 20) is zero-padded, q and the cache or page pool
alike, to the 64 instance and run with its own softmax scale
(`_head_dim.py`); paged == dense stays bitwise, as at 64.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, raise_on
from .._head_dim import instance_head_dim, pad_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 160, 256)


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_workspace.argtypes = [i, i, i, i]
    lib.decode_attention_workspace.restype = ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                            i, i, ctypes.c_float, p, p]
    lib.decode_attention_launch.restype = i
    lib.paged_decode_attention_launch.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  i, i, i, i, i,
                                                  ctypes.c_float, p]
    lib.paged_decode_attention_launch.restype = i


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" /
                  "decode_attention.cu", _declare)


def _check(q, k, v, kv_len, extra=()):
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    dh = q.shape[-1]
    if dh not in _HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {dh}")
    if not q.is_cuda:
        raise ValueError(f"decode attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len),
                    *extra):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")


def _workspace(lib, q, cap):
    """The f32 workspace of the per-split (m, l, acc) for a cache of `cap`
    logical positions."""
    b, h, dh = q.shape
    return torch.empty(lib.decode_attention_workspace(b, h, cap, dh),
                       dtype=torch.float32, device=q.device)


def decode_attention_fwd(q, k_cache, v_cache, kv_len, *, lse=False):
    """B1.  q (B, H, dh); k/v_cache (B, M, Hkv, dh); kv_len (B,) int32 on
    the card.  Returns (B, H, dh) in q's dtype; with `lse` also the rows'
    log-sum-exp of the scaled scores, (B, H) f32, -inf where kv_len is
    0 (the same launch: the merge kernel stores it)."""
    b, h, dh = q.shape
    m, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (b, m, hkv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % hkv or kv_len.shape != (b,):
        raise ValueError(f"bad heads ({h} vs {hkv}) or kv_len shape "
                         f"{tuple(kv_len.shape)}")
    run_dh = instance_head_dim(dh, _HEAD_DIMS, "decode attention")
    q, k_cache, v_cache = (pad_head_dim(t, run_dh)
                           for t in (q, k_cache, v_cache))
    _check(q, k_cache, v_cache, kv_len)
    lib = LIBRARY.load()
    ws = _workspace(lib, q, m)
    out = torch.empty_like(q)
    row_lse = torch.empty(b, h, dtype=torch.float32, device=q.device) \
        if lse else None
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), ws.data_ptr(), out.data_ptr(), b, hkv, h // hkv,
        m, run_dh, _DTYPES[q.dtype], dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
        row_lse.data_ptr() if lse else None)
    raise_on(err, "decode_attention")
    out = out if run_dh == dh else out[..., :dh].contiguous()
    return (out, row_lse) if lse else out


def paged_decode_attention_fwd(q, k_pages, v_pages, page_table, kv_len):
    """B2.  q (B, H, dh); k/v_pages (P+1, ps, Hkv, dh); page_table
    (B, max_pages) int32; kv_len (B,) int32, all on the card.  Returns
    (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape[3] != dh or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % hkv or kv_len.shape != (b,) or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"bad heads ({h} vs {hkv}), kv_len "
                         f"{tuple(kv_len.shape)} or page table "
                         f"{tuple(page_table.shape)}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"page_table must be int32, got {page_table.dtype}")
    run_dh = instance_head_dim(dh, _HEAD_DIMS, "decode attention")
    q, k_pages, v_pages = (pad_head_dim(t, run_dh)
                           for t in (q, k_pages, v_pages))
    _check(q, k_pages, v_pages, kv_len, extra=(("page_table", page_table),))
    lib = LIBRARY.load()
    ws = _workspace(lib, q, ps * page_table.shape[1])
    out = torch.empty_like(q)
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_len.data_ptr(), page_table.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, hkv, h // hkv, ps, page_table.shape[1], run_dh,
        _DTYPES[q.dtype], dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "paged_decode_attention")
    return out if run_dh == dh else out[..., :dh].contiguous()
