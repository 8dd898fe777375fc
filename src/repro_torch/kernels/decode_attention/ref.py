"""Plain PyTorch versions of the decode-attention kernels: the oracles the
CPU tests hold against the JAX package and `chip_smoke.py` holds the CUDA
kernels against, and what the wrappers run for CPU tensors.

Same semantics as the reference oracles: f32 math, scale dh**-0.5, scores
past kv_len set to -1e30 before the softmax, rows with kv_len == 0 return
exact zeros.
"""
from __future__ import annotations

import torch


def decode_attention_reference(q, k_cache, v_cache, kv_len):
    """q (B, H, dh); k/v_cache (B, M, Hkv, dh) (model layout); kv_len a
    scalar or (B,).  Returns (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    m, hkv = k_cache.shape[1], k_cache.shape[2]
    k = k_cache.transpose(1, 2).float()            # (B, Hkv, M, dh)
    v = v_cache.transpose(1, 2).float()
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * dh ** -0.5
    kv_len = torch.as_tensor(kv_len, device=q.device)
    lens = kv_len[:, None, None] if kv_len.dim() else kv_len
    valid = torch.arange(m, device=q.device) < lens
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, v)
    return torch.where(lens > 0, out, 0.0).to(q.dtype)


def gather_pages(pool, page_table):
    """Materialise the logical dense layout (B, max_pages * ps, Hkv, dh)
    from a (P+1, ps, Hkv, dh) pool and a (B, max_pages) page table."""
    b, mp = page_table.shape
    dense = pool[page_table]                        # (B, MP, ps, Hkv, dh)
    return dense.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     kv_len):
    """Gather pages to the dense layout and run the dense oracle.
    Positions >= kv_len, trash-page content included, get exact-zero
    probability."""
    return decode_attention_reference(
        q, gather_pages(k_pages, page_table),
        gather_pages(v_pages, page_table), kv_len)
