"""Plain PyTorch versions of the decode-attention kernels: the oracles the
CPU tests hold against the JAX package and `chip_smoke.py` holds the CUDA
kernels against, and what the wrappers run for CPU tensors.

Same semantics as the reference oracles: f32 math, scale dh**-0.5, scores
past kv_len set to -1e30 before the softmax, rows with kv_len == 0 return
exact zeros.

`split_decode_attention_reference` and its paged form spell out the CUDA
kernel's split-K algorithm in plain f32 PyTorch, for the tests: nothing
on the serving path calls them.
"""
from __future__ import annotations

import torch


def decode_attention_reference(q, k_cache, v_cache, kv_len,
                               return_lse: bool = False):
    """q (B, H, dh); k/v_cache (B, M, Hkv, dh) (model layout); kv_len a
    scalar or (B,).  Returns (B, H, dh) in q's dtype; with `return_lse`
    also the log-sum-exp of each (row, head)'s scaled scores below
    kv_len, (B, H) f32, -inf where kv_len is 0."""
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
    p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    out = torch.where(lens > 0, torch.einsum("bhk,bhkd->bhd", p, v),
                      0.0).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(torch.where(valid, s, -torch.inf), dim=-1)


def merge_partials(outs, lses):
    """The attention of one query over a cache split into slices, from
    each slice's normalised partial: outs (R, ..., dh), lses (R, ...) f32
    (the slices' log-sum-exps, -inf for an empty slice).  out = sum_r
    exp(lse_r - max) out_r / sum_r exp(lse_r - max), in f32; exact zeros
    where every slice is empty.  Returns outs' dtype.  (The reference gets
    this merge from XLA's partitioning of the softmax's reductions.)"""
    mx = lses.amax(0)
    live = lses > -torch.inf
    w = torch.where(live, torch.exp(lses - torch.where(live, mx, 0.0)),
                    0.0)
    den = w.sum(0)
    out = (w[..., None] * outs.float()).sum(0)
    out = torch.where(den[..., None] > 0,
                      out / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.to(outs.dtype)


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


def _split_merge(q, k, v, kv_len, chunk):
    """q (B, H, dh); k/v (B, n_split * chunk, Hkv, dh) in logical position
    order; kv_len (B,).  Positions >= kv_len are zeroed before any
    arithmetic, so what they held (NaN included) never matters."""
    b, h, dh = q.shape
    hkv = k.shape[2]
    n = k.shape[1] // chunk
    lens = kv_len.reshape(-1).to(torch.int64)
    valid = torch.arange(n * chunk, device=q.device)[None] < lens[:, None]
    keep = valid[:, :, None, None]
    k = torch.where(keep, k.float(), 0.0).reshape(b, n, chunk, hkv, dh)
    v = torch.where(keep, v.float(), 0.0).reshape(b, n, chunk, hkv, dh)
    # per split: (m, l, acc) over its positions < kv_len
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bkgd,bnckd->bnkgc", qg, k) * dh ** -0.5
    vmask = valid.reshape(b, n, 1, 1, chunk)
    s = torch.where(vmask, s, -torch.inf)
    m = s.amax(-1)                                  # -inf for empty splits
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bnkgc,bnckd->bnkgd", p, v)
    # merge: the max over the used splits, then fold them in split order;
    # splits past kv_len are skipped, not multiplied by zero
    live = torch.arange(n, device=q.device)[None] < \
        ((lens + chunk - 1) // chunk)[:, None]
    mx = torch.where(live[:, :, None, None], m, -torch.inf).amax(1)
    den = torch.zeros_like(mx)
    out = torch.zeros(b, hkv, h // hkv, dh, device=q.device)
    for i in range(n):
        sel = live[:, i, None, None]
        w = torch.exp(m[:, i] - mx)
        den = torch.where(sel, den + w * l[:, i], den)
        out = torch.where(sel[..., None], out + w[..., None] * acc[:, i], out)
    out = torch.where((lens > 0)[:, None, None, None], out / den[..., None],
                      0.0)
    return out.reshape(b, h, dh).to(q.dtype)


def split_decode_attention_reference(q, k_cache, v_cache, kv_len, chunk):
    """The kernels' split-K algorithm, in f32 (the bf16 kernel also rounds
    P to bf16 for its P.V product).  The partition rule: split s covers
    logical positions [s * chunk, (s + 1) * chunk) below kv_len[b], with
    `chunk` a constant (never derived from the capacity, the batch or the
    page size); each split yields (m, l, acc); splits 0 ..
    ceil(kv_len / chunk) - 1 are merged in that order and the rest are
    skipped.  q (B, H, dh); k/v_cache (B, M, Hkv, dh); kv_len (B,)."""
    m = k_cache.shape[1]
    n = -(-m // chunk)
    pos = torch.arange(n * chunk, device=q.device).clamp(max=max(m - 1, 0))
    return _split_merge(q, k_cache[:, pos], v_cache[:, pos], kv_len, chunk)


def paged_split_decode_attention_reference(q, k_pages, v_pages, page_table,
                                           kv_len, chunk):
    """The same split-K algorithm, reading each logical position t through
    the page table: pool row (page_table[b, t // ps], t % ps)."""
    ps = k_pages.shape[1]
    cap = ps * page_table.shape[1]
    n = -(-cap // chunk)
    pos = torch.arange(n * chunk, device=q.device).clamp(max=max(cap - 1, 0))
    pages = page_table[:, pos // ps]                # (B, n * chunk)
    return _split_merge(q, k_pages[pages, pos % ps], v_pages[pages, pos % ps],
                        kv_len, chunk)
