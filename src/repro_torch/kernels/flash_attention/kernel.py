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

The bf16 kernel walks its work items in bands of (batch, kv head) pairs
whose K/V fits a share of the card's L2 (`kv_band`); `work_items` is the
order in plain Python, as the kernel's `work_item` computes it, and
`kv_traffic` the K/V bytes an order loads and how many of them a simple
model of L2 (not a measurement) counts as misses.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, raise_on
from .._head_dim import instance_head_dim, pad_head_dim
from .ref import BLOCK

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 160)
# K/V (bf16) within 1 / L2_WHOLE of the card's L2 stays there: a call's
# whole K/V that small is one band; a larger one is cut into bands of at
# most 1 / L2_PARTS of L2 (`chip_smoke.py --b3-against` times the shares)
L2_WHOLE = 4
L2_PARTS = 8


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, ctypes.c_float, p, i, i]
    lib.flash_attention_launch.restype = i


def kv_band(batch: int, hkv: int, skv: int, dh: int, l2_bytes: int) -> int:
    """(batch, kv head) pairs per band.  One band if the whole K and V (2
    Skv dh bf16 values a pair) fit l2_bytes / L2_WHOLE; otherwise as few
    bands as keep each within l2_bytes / L2_PARTS, the pairs spread
    evenly over them (a pair too large for the share is a band of its
    own)."""
    pair = 2 * skv * dh * 2
    pairs = batch * hkv
    if pairs * pair <= l2_bytes // L2_WHOLE:
        return pairs
    cap = max(1, l2_bytes // L2_PARTS // pair)
    n_bands = -(-pairs // cap)
    return -(-pairs // n_bands)


def work_items(batch: int, heads: int, hkv: int, sq: int, skv: int,
               causal: bool, q_offset: int, band: int):
    """The bf16 kernel's work items in their order, as (query tile, head,
    batch, key tiles): bands of `band` (batch, kv head) pairs, pair u =
    b Hkv + hk, the last band possibly smaller; inside a band by query
    tile, then the band's pairs, the heads of a group side by side.  The
    last band runs its heaviest query tiles first, the one before it its
    lightest first, and so on back, so that the kernel's static rounds
    meet no band's light end beside the next band's heavy start."""
    group, n_qt = heads // hkv, -(-sq // BLOCK)
    pairs = batch * hkv
    n_bands = -(-pairs // band)
    items = []
    for k, u0 in enumerate(range(0, pairs, band)):
        mine = []
        for qt in range(n_qt - 1, -1, -1):
            q0 = qt * BLOCK
            kend = min(skv, q0 + BLOCK + q_offset) if causal else skv
            for u in range(u0, min(pairs, u0 + band)):
                mine += [(qt, (u % hkv) * group + gi, u // hkv,
                          -(-kend // BLOCK)) for gi in range(group)]
        items += mine[::-1] if (n_bands - 1 - k) % 2 else mine
    return items


def kv_traffic(batch: int, heads: int, hkv: int, sq: int, skv: int,
               dh: int, causal: bool, q_offset: int, band: int,
               l2_bytes: int):
    """K/V bytes (bf16) of an order: (loaded, missed by the model).
    Loaded: every key tile every item reads (rows past Skv are not
    read).  Missed: what a model of L2 counts as read from device
    memory: a band whose K/V fits l2_bytes / L2_WHOLE once, otherwise
    once per GQA group (its heads run side by side).  A model, not a
    measurement: where the items of a band that does not fit still find
    its K/V in L2 (the 2,048 query rows at offset 30,720 of
    `chip_smoke.py`'s phase 26b do), it counts too many."""
    tile_keys = [min(BLOCK, skv - t * BLOCK)
                 for t in range(-(-skv // BLOCK))]
    per_key = 2 * dh * 2
    pairs, group, n_qt = batch * hkv, heads // hkv, -(-sq // BLOCK)
    loaded = missed = 0
    items = work_items(batch, heads, hkv, sq, skv, causal, q_offset, band)
    for u0 in range(0, pairs, band):
        n = min(band, pairs - u0)
        mine, items = items[:n * group * n_qt], items[n * group * n_qt:]
        band_loads = sum(sum(tile_keys[:nt]) for *_, nt in mine) * per_key
        loaded += band_loads
        fits = n * skv * per_key <= l2_bytes // L2_WHOLE
        missed += n * skv * per_key if fits else band_loads // group
    return loaded, missed


def _l2_bytes(device) -> int:
    """The card's L2 size (a cached host query; no sync)."""
    return torch.cuda.get_device_properties(device).L2_cache_size


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


def flash_attention_fwd(q, k, v, *, causal: bool, q_offset: int = 0,
                        band: int | None = None):
    """B3.  q (B, H, Sq, dh); k, v (B, Hkv, Skv, dh), any strides with the
    head dim contiguous (a head-major view of the (B, S, H, dh) model
    layout goes in as it is).  Causal means key position <= query
    position + q_offset (q's rows sit at q_offset, q_offset + 1, ... of
    the keys' positions).  Returns a (B, Sq, H, dh)-contiguous tensor viewed as
    (B, H, Sq, dh), in q's dtype.  A head dim below 64 runs on the 64
    instance, zero-padded, at its own scale dh**-0.5.  `band`: (batch,
    kv head) pairs per band of the bf16 kernel's order, `kv_band`'s rule
    for the card's L2 if None (more than B Hkv is one band); it changes
    no output bit."""
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
    if q.dtype == torch.bfloat16:
        if band is None:
            band = kv_band(b, hkv, skv, run_dh, _l2_bytes(q.device))
        if band < 1:
            raise ValueError(f"band {band} < 1")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, h // hkv, sq, skv, run_dh, _DTYPES[q.dtype], int(causal),
        dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
        int(q_offset), min(band or 1, b * hkv))
    raise_on(err, "flash_attention")
    if run_dh != dh:
        out = out[..., :dh].transpose(1, 2).contiguous().transpose(1, 2)
    return out
