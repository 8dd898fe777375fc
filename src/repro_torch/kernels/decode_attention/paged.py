"""Paged decode attention (kernel B2): the same attention as B1, walking a
per-row (B, max_pages) page table into a shared (P+1, ps, Hkv, dh) pool
whose last page P is the trash page.

A CPU tensor runs the plain version (gather pages, then the dense oracle);
a CUDA tensor launches the CUDA kernel or raises.  The kernel reduces over
logical positions in the same order as B1, so paged == dense bitwise on
the card.  `paged_decode_attention.launches` counts the calls that
launch the kernels (a split and a merge kernel each).
"""
from __future__ import annotations

from . import kernel
from .ops import kv_lens
from .ref import paged_decode_attention_reference


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len):
    """q (B, 1, H, dh) or (B, H, dh); pools (P+1, ps, Hkv, dh); page_table
    (B, max_pages) int32; kv_len a scalar or (B,)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    lens = kv_lens(kv_len, q.shape[0], q.device)
    if q.device.type == "cpu":
        out = paged_decode_attention_reference(q, k_pages, v_pages,
                                               page_table, lens)
    else:
        out = kernel.paged_decode_attention_fwd(q, k_pages, v_pages,
                                                page_table, lens)
        paged_decode_attention.launches += 1
    return out[:, None] if squeeze else out


paged_decode_attention.launches = 0
