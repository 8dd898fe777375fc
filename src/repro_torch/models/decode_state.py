"""DecodeState specs for the serving engine: the transformer KV family
(dense and MoE, dense and paged) and the RG-LRU and xLSTM carry families.

A spec tells the engine how to allocate the per-slot state
(`init_state`), advance it one token (`decode`), prefill a ragged bucket
(`prefill`, admit-masked), hold inactive rows (`freeze`), and, for the
paged layout, map and free pages (`advance`, `release`).  The base class
carries the defaults of a carry family: a whole-tree `freeze`, identity
`advance` and `release`.  The paged allocator (a free-page stack, its
top and per-page refcounts) is device tensors updated by whole-batch
tensor ops, so alloc and free run inside the engine's decode block with
no host round-trip.

Where the slot axis lives (`batch_axes`) and which leaves grow with the
sequence (`length_axes`, -1 for an O(1) or O(window) carry leaf) make
the engine's migration machinery four generic tree operations:
`state_rows`, `merge_rows`, `delta_since` and `delta_apply`.  They are
the defaults of the spec's hooks (`export_rows`, `import_rows`,
`export_delta_rows`, `apply_delta_rows`); the paged layout overrides
them and ships dense logical rows, the wire format, so a bundle moves
between any two layouts with the same max_len.  Every index vector is
full-width (max_batch,), so one op serves every migration size.

Large buffers (the dense cache, the page pools, the RG-LRU attention
ring) are written in place; the small tensors (pos, page table, free
stack, refcounts, prefix table, the RG-LRU carries) are replaced, never
mutated, so `freeze` can still read the values from before a sub-step.
The migration ops return fresh tensors: a bundle never aliases the state
it was gathered from, so its source may go on decoding.
"""
from __future__ import annotations

import copy

import torch

from . import rglru as _rglru
from . import transformer as _transformer
from . import xlstm as _xlstm
from .rglru import RGLRUConfig
from .transformer import TransformerConfig
from .xlstm import XLSTMConfig


# The generic gathers/scatters below are the bodies of the engine's
# export/import/delta/standby entry points; `python -m
# repro_torch.analysis.lint --budgets` (entries "engine-serve" /
# "engine-serve-rglru") asserts they run with zero host syncs for both a
# KV and a carry family.
LINT_BUDGET = {"host_callbacks": 0}


def _bcast(vec, ndim: int, ax: int):
    """Reshape a (B,) vector to broadcast against a leaf whose slot axis
    is `ax`."""
    shape = [1] * ndim
    shape[ax] = vec.shape[0]
    return vec.reshape(shape)


def _tree_map(fn, tree, *rest):
    """fn leaf by leaf over nested dicts and tuples of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    """Leaves of nested dicts and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def admit_merge(state, fresh, axes, admit):
    """Overwrite `admit`-masked slot rows of `state` with `fresh` rows
    (trees of tensors of one structure; `axes` gives each slot axis)."""
    return _tree_map(lambda o, n, ax: torch.where(_bcast(admit, o.dim(), ax),
                                                 n, o), state, fresh, axes)


def _hold(new, old, active, axes):
    """`new` where `active`, else `old`, row by row over a tree."""
    return _tree_map(
        lambda n, o, ax: torch.where(_bcast(active, n.dim(), ax), n, o),
        new, old, axes)


def _take(x, idx, ax: int):
    """Rows `idx` of `x` along axis `ax`, as a fresh tensor."""
    return torch.index_select(x, ax, idx.long())


def _take_along(x, ind, ax: int, lax: int):
    """x gathered along its length axis `lax` by a (B, W) index whose row b
    is read from slot row b of axis `ax`."""
    shape = [1] * x.dim()
    shape[ax], shape[lax] = ind.shape
    size = list(x.shape)
    size[lax] = ind.shape[1]
    return torch.gather(x, lax, ind.long().reshape(shape).expand(size))


def state_rows(state, axes, idx):
    """Gather slot rows `idx` (full-width, (max_batch,)) of every leaf into
    fresh tensors."""
    return _tree_map(lambda x, ax: _take(x, idx, ax), state, axes)


def merge_rows(state, bundle, axes, src_for_dst, mask):
    """Scatter bundle rows into `mask`-ed slots: row d takes bundle row
    `src_for_dst[d]`; unmasked rows are untouched, so resident generations
    cannot be perturbed by an import."""
    def leaf(old, b, ax):
        g = _take(b, src_for_dst, ax)
        return torch.where(_bcast(mask, old.dim(), ax), g, old)
    return _tree_map(leaf, state, bundle, axes)


def delta_since(state, axes, laxes, idx, starts, width: int):
    """Gather rows `idx`, windowed to [starts, starts + width) along each
    leaf's length axis (clipped to the leaf).  Leaves with a length axis
    of -1 (recurrent carries, rings, pos) ship whole."""
    def leaf(x, ax, lax_):
        g = _take(x, idx, ax)
        if lax_ < 0:
            return g
        if not ax < lax_:
            raise ValueError("the slot axis must precede the length axis")
        cols = starts[:, None] + torch.arange(width, device=x.device)
        return _take_along(g, torch.clamp(cols, 0, g.shape[lax_] - 1),
                           ax, lax_)
    return _tree_map(leaf, state, axes, laxes)


def delta_apply(state, bundle, axes, laxes, src_for_dst, starts, mask):
    """Scatter a `delta_since` bundle into `mask`-ed standby rows: row r
    takes bundle row `src_for_dst[r]`, windowed leaves at [starts[r],
    starts[r] + W) cut to the rows its source wrote (its pos), carry
    leaves whole.  The standby pos becomes the replication cursor:
    min(starts + W, source pos) where any leaf is windowed, else the
    source pos (the whole state shipped, so the standby is promotable
    after every sync)."""
    pos = _take(bundle["pos"], src_for_dst, 0)

    def rest(t):
        return {k: v for k, v in t.items() if k != "pos"}
    widths = [b.shape[lx] for b, lx in
              zip(_leaves(rest(bundle)), _leaves(rest(laxes))) if lx >= 0]

    def leaf(old, b, ax, lax_):
        g = _take(b, src_for_dst, ax)
        if lax_ < 0:
            return torch.where(_bcast(mask, old.dim(), ax), g, old)
        w, m = b.shape[lax_], old.shape[lax_]
        pend = torch.clamp(pos - starts, 0, w)            # rows to copy
        rel = torch.arange(m, device=old.device)[None, :] - starts[:, None]
        in_win = (rel >= 0) & (rel < pend[:, None]) & mask[:, None]
        shape = [1] * old.dim()
        shape[ax], shape[lax_] = rel.shape
        return torch.where(in_win.reshape(shape),
                           _take_along(g, torch.clamp(rel, 0, w - 1),
                                       ax, lax_), old)

    out = _tree_map(leaf, rest(state), rest(bundle), rest(axes), rest(laxes))
    cursor = torch.minimum(starts + widths[0], pos) if widths else pos
    out["pos"] = torch.where(mask, cursor, state["pos"])
    return out


def _set_drop(dst, idx, vals):
    """`dst.at[idx].set(vals, mode="drop")` along axis 0: entries whose
    index is >= len(dst) are dropped."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext[idx.clamp(max=n).long()] = vals
    return ext[:n]


# --------------------------------------------------------------------------
# paged-pool primitives
# --------------------------------------------------------------------------
def _alloc_rows(ptab, free, top, ref, take):
    """Pop one page per True entry of `take` (B, max_pages) off the free
    stack into the matching page-table entries, refcount 1 each.  Entries
    are numbered row-major by an exclusive cumsum, so a batch of
    allocations is one gather and one scatter.  The host's admission
    gating guarantees the stack holds enough pages."""
    t32 = take.to(torch.int32)
    flat = t32.reshape(-1)
    off = (torch.cumsum(flat, 0, dtype=torch.int32) - flat).reshape(
        take.shape)
    pool = free.shape[0]
    pid = free[torch.clamp(top - 1 - off, 0, pool - 1).long()]
    ptab2 = torch.where(take, pid, ptab)
    ref2 = ref.index_add(0, torch.where(take, pid, pool).reshape(-1).long(),
                         flat)
    return ptab2, ref2, top - flat.sum(dtype=torch.int32)


def _release_rows(ptab, free, top, ref, drop):
    """Decref every mapped page of `drop`-masked rows; pages whose count
    reaches zero go back on the free stack (once each, even when two
    dropped rows share them) and the rows' entries reset to the trash id.
    Prefix-cache pins hold an extra reference."""
    pool = free.shape[0]
    trash = pool
    dec = drop[:, None] & (ptab != trash)
    ref2 = ref.index_add(0, torch.where(dec, ptab, trash).reshape(-1).long(),
                         -dec.to(torch.int32).reshape(-1))
    pages = torch.arange(pool + 1, dtype=torch.int32, device=ref.device)
    became = (ref2 == 0) & (ref > 0) & (pages < pool)
    b32 = became.to(torch.int32)
    rank = torch.cumsum(b32, 0, dtype=torch.int32) - b32
    dst = torch.where(became, top + rank, pool)
    free2 = _set_drop(free, dst, pages.to(free.dtype))
    ptab2 = torch.where(drop[:, None], trash, ptab)
    return ptab2, free2, top + b32.sum(dtype=torch.int32), ref2


def _gather_logical(pool, ptab):
    """(L, P+1, ps, Hkv, dh) pool + (B, max_pages) table -> the logical
    dense layout (L, B, max_pages*ps, Hkv, dh)."""
    g = pool[:, ptab.long()]                    # (L, B, MP, ps, Hkv, dh)
    b, mp = ptab.shape
    return g.reshape(pool.shape[0], b, mp * pool.shape[2], *pool.shape[3:])


def _scatter_logical(pool, ptab, vals, write):
    """Write logical rows `vals` (L, B, M, Hkv, dh) into mapped pages, in
    place: position t of row b lands at (ptab[b, t//ps], t%ps).  Entries
    with write == False go to the trash page."""
    ps = pool.shape[2]
    b, m = write.shape
    t = torch.arange(m, device=pool.device)
    pid = torch.where(write, ptab[:, t // ps], pool.shape[1] - 1)
    off = (t % ps).expand(b, m)
    pool[:, pid.long(), off] = vals.to(pool.dtype)
    return pool


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
class DecodeStateSpec:
    """Base: the carry-family defaults."""

    state_kind = "carry"

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def freeze(self, new, old, active):
        """Hold inactive rows across a decode sub-step: recurrent carries
        advance every sub-step, so inactive rows keep their whole old
        tree.  Right only for leaves that `decode` returns fresh; a family
        that writes a leaf in place overrides this."""
        return _hold(new, old, active, self.batch_axes())

    def advance(self, state, active):
        """Pre-decode bookkeeping for `active` rows (paged: map the next
        page); identity for row-partitioned families."""
        return state

    def release(self, state, drop):
        """Return per-row resources of `drop`-masked rows (paged: free
        their pages); identity for row-partitioned families."""
        return state

    @property
    def windowed(self) -> bool:
        """True when a leaf grows with the sequence (KV families): the
        router then replicates in windowed deltas behind a cursor, while
        a carry family ships its whole state on every sync."""
        return any(lx >= 0 for lx in _leaves(self.length_axes()))

    # --- migration and replication hooks: the four tree ops over the
    # axis declarations; the paged layout overrides them with the same
    # wire format
    def export_rows(self, state, idx):
        return state_rows(state, self.batch_axes(), idx)

    def import_rows(self, state, bundle, src_for_dst, mask):
        return merge_rows(state, bundle, self.batch_axes(), src_for_dst,
                          mask)

    def export_delta_rows(self, state, idx, starts, width):
        return delta_since(state, self.batch_axes(), self.length_axes(),
                           idx, starts, width)

    def apply_delta_rows(self, state, bundle, src_for_dst, starts, mask):
        return delta_apply(state, bundle, self.batch_axes(),
                           self.length_axes(), src_for_dst, starts, mask)

    def init_standby(self, state):
        """The warm-standby store: zeros in the wire format of `state`."""
        return _tree_map(torch.zeros_like, state)

    def row_wire_bytes(self, max_len):
        """Wire bytes of one slot row, from the axis declarations and the
        dtypes this spec allocates (the engine's compute dtype): (full,
        per_pos, carry).  full is one row's whole state, per_pos the bytes
        per cache position over the windowed leaves, carry the leaves
        shipped whole on every sync (a carry family's entire row).
        Computed from shapes on the meta device: no device work."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        st = meta.init_state(1, max_len)
        full = per_pos = windowed_bytes = 0
        for leaf, lx in zip(_leaves(st), _leaves(self.length_axes())):
            nb = leaf.numel() * leaf.element_size()
            full += nb
            if lx >= 0:
                per_pos += nb // leaf.shape[lx]
                windowed_bytes += nb
        return full, per_pos, full - windowed_bytes


class TransformerDecodeState(DecodeStateSpec):
    """KV family: (L, B, M, Hkv, dh) cache rows plus a per-row pos.  It
    covers the MoE configs too ("kv+experts": the decode state is still
    per-slot KV rows; the expert FFN routes every row of a call
    together)."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__(cfg, device)
        self.state_kind = "kv+experts" if cfg.is_moe else "kv"

    def batch_axes(self):
        return {"k": 1, "v": 1, "pos": 0}

    def length_axes(self):
        return {"k": 2, "v": 2, "pos": -1}

    def init_state(self, batch, max_len, dtype=None):
        st = _transformer.init_cache(self.cfg, batch, max_len, dtype,
                                     device=self.device)
        st["pos"] = torch.zeros((batch,), dtype=torch.int32,
                                device=self.device)
        return st

    def decode(self, params, state, last):
        return _transformer.decode_step(params, state, last, self.cfg)

    def prefill(self, params, state, tokens, lens, admit, page_ops=None):
        """Ragged prefill of a (B, bucket) block on a fresh bucket cache;
        admitted rows' cache prefix and pos are merged into `state`."""
        b, lb = tokens.shape
        tmp = self.init_state(b, lb)
        logits, tmp = _transformer.decode_step(
            params, tmp, tokens, self.cfg, last_idx=torch.clamp(lens - 1,
                                                                min=0))
        w = tmp["k"].shape[2]                  # bucket len, block-aligned
        adm5 = admit[None, :, None, None, None]
        for nm in ("k", "v"):
            head = state[nm][:, :, :w]
            head.copy_(torch.where(adm5, tmp[nm], head))
        return logits, {**state, "pos": torch.where(admit, lens,
                                                    state["pos"])}

    def freeze(self, new, old, active):
        # inactive rows only write into the masked tail (their pos is
        # held), so only pos needs the select
        return {**new, "pos": torch.where(active, new["pos"], old["pos"])}


class PagedTransformerDecodeState(TransformerDecodeState):
    """Paged KV family: a shared pool of physical pages (L, P+1, ps, Hkv,
    dh) addressed through a per-row (B, max_pages) int32 page table.
    Memory tracks live tokens, and identical prompt heads share pages via
    refcounts.  Invariants:
      * pages covering [0, pos) of an active row are mapped; entries past
        ceil(pos/ps) hold the trash id (= pool_pages)
      * a page is on the free stack iff its refcount is 0
      * prefix-published pages carry a +1 pin, so they outlive their
        publisher
      * host-side admission reserves worst-case pages per request, so the
        stack never underflows
    Paged == dense bitwise: positions >= kv_len never enter a sum, and
    mapped positions hold the values the dense cache holds.
    """

    def __init__(self, cfg: TransformerConfig, *, page_size: int,
                 max_batch: int, max_len: int, pool_pages=None,
                 prefix_entries: int = 0, device="cuda"):
        super().__init__(cfg, device)
        self.state_kind += "-paged"
        if cfg.window is not None:
            raise ValueError("paged KV serving does not support local "
                             "(windowed) attention yet")
        if cfg.n_codebooks > 1:
            raise ValueError("paged KV serving supports single-codebook "
                             "token streams only")
        m = -(-max_len // 128) * 128       # same padding as init_cache
        if m % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the padded cache "
                f"length {m} (max_len {max_len} rounded up to 128)")
        self.page_size = page_size
        self.padded_len = m
        self.max_pages = m // page_size
        self.pool_pages = (pool_pages if pool_pages is not None
                           else max_batch * self.max_pages)
        if self.pool_pages < self.max_pages:
            raise ValueError(
                f"pool_pages {self.pool_pages} cannot hold even one "
                f"max_len row ({self.max_pages} pages)")
        self.prefix_entries = prefix_entries
        self.max_batch = max_batch
        self.max_len = max_len
        self._dense = TransformerDecodeState(cfg, device)

    def init_state(self, batch, max_len, dtype=None):
        dev, trash = self.device, self.pool_pages
        kp = _transformer.init_paged_pool(self.cfg, self.pool_pages,
                                          self.page_size, dtype, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        st = {"kp": kp, "vp": torch.zeros_like(kp),
              "ptab": torch.full((batch, self.max_pages), trash, **i32),
              "pos": torch.zeros((batch,), **i32),
              "free": torch.arange(self.pool_pages, **i32),
              "top": torch.tensor(self.pool_pages, **i32),
              "ref": torch.zeros((self.pool_pages + 1,), **i32)}
        if self.prefix_entries:
            st["pf_tab"] = torch.full((self.prefix_entries, self.max_pages),
                                      trash, **i32)
            st["pf_len"] = torch.zeros((self.prefix_entries,), **i32)
        return st

    def decode(self, params, state, last):
        return _transformer.paged_decode_step(params, state, last, self.cfg)

    def advance(self, state, active):
        """Map a fresh page for each active row whose next write position
        starts a new page (pos % ps == 0)."""
        ps = self.page_size
        pos = state["pos"]
        col = torch.clamp(pos // ps, 0, self.max_pages - 1)
        need = active & (pos % ps == 0) & (pos // ps < self.max_pages)
        b = pos.shape[0]
        take = torch.zeros((b, self.max_pages), dtype=torch.bool,
                           device=pos.device)
        take[torch.arange(b, device=pos.device), col.long()] = need
        ptab, ref, top = _alloc_rows(state["ptab"], state["free"],
                                     state["top"], state["ref"], take)
        return {**state, "ptab": ptab, "ref": ref, "top": top}

    def release(self, state, drop):
        ptab, free, top, ref = _release_rows(
            state["ptab"], state["free"], state["top"], state["ref"], drop)
        return {**state, "ptab": ptab, "free": free, "top": top, "ref": ref}

    def live_pages(self, state):
        """Allocated page count (device scalar)."""
        return self.pool_pages - state["top"]

    def prefill(self, params, state, tokens, lens, admit, page_ops=None):
        """Bucketed prefill into the pool: the model runs on a dense
        bucket cache (the dense engine's logits, bit for bit), then the
        admitted rows' fresh KV is re-paged.  Shared prefix pages are
        mapped from the prefix table (+1 ref) instead of re-allocated,
        fresh pages come off the free stack, and rows flagged for
        publication pin their head pages into the prefix table.

        `page_ops` (host-side prefix matching): (B,) int32 pf_entry (-1 =
        no shared prefix), pf_n (shared pages), pf_store (-1 = do not
        publish), pf_store_n (pages to publish)."""
        b, lb = tokens.shape
        tmp = self._dense.init_state(b, lb)
        logits, tmp = _transformer.decode_step(
            params, tmp, tokens, self.cfg,
            last_idx=torch.clamp(lens - 1, min=0))

        ps, mp, trash = self.page_size, self.max_pages, self.pool_pages
        dev = tokens.device
        cols = torch.arange(mp, device=dev)[None]
        ptab = torch.where(admit[:, None], trash, state["ptab"])
        ref, top = state["ref"], state["top"]
        if page_ops is None:
            none = torch.full((b,), -1, dtype=torch.int32, device=dev)
            page_ops = {"pf_entry": none, "pf_n": none + 1,
                        "pf_store": none, "pf_store_n": none + 1}
        pf_entry, pf_n = page_ops["pf_entry"], page_ops["pf_n"]
        pf_store, pf_store_n = page_ops["pf_store"], page_ops["pf_store_n"]

        new = dict(state)
        hit = admit & (pf_entry >= 0)
        shared = torch.where(hit, pf_n, 0)
        if self.prefix_entries:
            src = state["pf_tab"][torch.clamp(
                pf_entry, 0, self.prefix_entries - 1).long()]
            use = hit[:, None] & (cols < shared[:, None])
            ptab = torch.where(use, src, ptab)
            ref = ref.index_add(
                0, torch.where(use, src, trash).reshape(-1).long(),
                use.to(torch.int32).reshape(-1))

        # allocate the non-shared remainder of ceil(lens / ps) pages
        pages_needed = -(-lens // ps)
        take = admit[:, None] & (cols >= shared[:, None]) & \
            (cols < pages_needed[:, None])
        ptab, ref, top = _alloc_rows(ptab, state["free"], top, ref, take)

        # re-page the fresh KV, skipping shared pages (already resident)
        t = torch.arange(tmp["k"].shape[2], device=dev)[None]
        write = admit[:, None] & (t >= (shared * ps)[:, None]) & \
            (t < lens[:, None])
        new["kp"] = _scatter_logical(state["kp"], ptab, tmp["k"], write)
        new["vp"] = _scatter_logical(state["vp"], ptab, tmp["v"], write)

        if self.prefix_entries:
            store = admit & (pf_store >= 0)
            ents = torch.where(store, pf_store, self.prefix_entries)
            vals = torch.where(cols < pf_store_n[:, None], ptab, trash)
            new["pf_tab"] = _set_drop(state["pf_tab"], ents, vals)
            new["pf_len"] = _set_drop(state["pf_len"], ents, pf_store_n)
            pin = store[:, None] & (cols < pf_store_n[:, None])
            ref = ref.index_add(
                0, torch.where(pin, ptab, trash).reshape(-1).long(),
                pin.to(torch.int32).reshape(-1))

        new.update(ptab=ptab, ref=ref, top=top,
                   pos=torch.where(admit, lens, state["pos"]))
        return logits, new

    # --- migration and replication: the dense logical rows on the wire
    # (the axis declarations above describe that format, not the pool)
    def export_rows(self, state, idx):
        ptab = _take(state["ptab"], idx, 0)
        return {"k": _gather_logical(state["kp"], ptab),
                "v": _gather_logical(state["vp"], ptab),
                "pos": _take(state["pos"], idx, 0)}

    def import_rows(self, state, bundle, src_for_dst, mask):
        """Target rows drop their pages, then take ceil(pos / ps) fresh
        pages each (the allocator's row-major order, as prefill takes
        them) and their positions [0, pos) are written into them."""
        state = self.release(state, mask)
        bk = _take(bundle["k"], src_for_dst, 1)
        bv = _take(bundle["v"], src_for_dst, 1)
        pos = torch.where(mask, _take(bundle["pos"], src_for_dst, 0), 0)
        cols = torch.arange(self.max_pages, device=pos.device)[None]
        take = mask[:, None] & (cols < (-(-pos // self.page_size))[:, None])
        ptab, ref, top = _alloc_rows(state["ptab"], state["free"],
                                     state["top"], state["ref"], take)
        t = torch.arange(bk.shape[2], device=pos.device)[None]
        write = mask[:, None] & (t < pos[:, None])
        return {**state, "ptab": ptab, "ref": ref, "top": top,
                "kp": _scatter_logical(state["kp"], ptab, bk, write),
                "vp": _scatter_logical(state["vp"], ptab, bv, write),
                "pos": torch.where(mask, pos, state["pos"])}

    def export_delta_rows(self, state, idx, starts, width):
        ptab = _take(state["ptab"], idx, 0)
        cols = torch.clamp(
            starts[:, None] + torch.arange(width, device=ptab.device), 0,
            self.padded_len - 1)                           # (B, W)
        pid = torch.gather(ptab, 1, (cols // self.page_size).long())
        off = (cols % self.page_size).long()
        return {"k": state["kp"][:, pid.long(), off],
                "v": state["vp"][:, pid.long(), off],
                "pos": _take(state["pos"], idx, 0)}

    def init_standby(self, state):
        """The standby store holds the wire format: dense logical rows."""
        return self._dense.init_state(self.max_batch, self.max_len)

    def row_wire_bytes(self, max_len):
        return self._dense.row_wire_bytes(max_len)


class RGLRUDecodeState(DecodeStateSpec):
    """Griffin/RecurrentGemma carry: per-layer (h, conv) RG-LRU states,
    an O(window) local-attention ring and a per-row pos.  The ring's slots
    are position-modular, not cursor-contiguous, so no leaf has a length
    axis (all -1), as in the reference: the ring and the carries ship
    whole on every standby sync, O(window) and not O(seq), and a standby
    is promotable after every sync.

    `decode` writes the ring in place at slot pos % W for every row,
    inactive ones included; it keeps the slots it overwrote on the spec,
    and `freeze` writes them back into inactive rows before the base
    class's select holds the other leaves.  So an inactive row's whole
    state stays bit-stable across a sub-step, as the reference's
    whole-tree select keeps it."""

    _ring_held = None

    def init_state(self, batch, max_len, dtype=None):
        st = _rglru.init_cache(self.cfg, batch, max_len, dtype,
                               device=self.device)
        st["pos"] = torch.zeros((batch,), dtype=torch.int32,
                                device=self.device)
        return st

    def batch_axes(self):
        ax = {"rec_a": (1, 1), "rec_b": (1, 1), "attn": (1, 1), "pos": 0}
        if self.cfg.n_tail_rec:
            ax["tail"] = (1, 1)
        return ax

    def length_axes(self):
        return _tree_map(lambda _: -1, self.batch_axes())

    def decode(self, params, state, last):
        ck, cv = state["attn"]
        rows = torch.arange(ck.shape[1], device=ck.device)
        slot = (state["pos"] % ck.shape[2]).long()
        held = (ck[:, rows, slot], cv[:, rows, slot])     # copies
        self._ring_held = held, rows, slot
        return _rglru.decode_step(params, state, last, self.cfg)

    def prefill(self, params, state, tokens, lens, admit, page_ops=None):
        logits, fresh = _rglru.prefill_cells(params, tokens, lens, self.cfg)
        return logits, admit_merge(state, fresh, self.batch_axes(), admit)

    def freeze(self, new, old, active):
        (hk, hv), rows, slot = self._ring_held
        self._ring_held = None
        keep = active[None, :, None, None]
        for ring, held in zip(new["attn"], (hk, hv)):
            ring[:, rows, slot] = torch.where(keep, ring[:, rows, slot], held)
        rest = super().freeze({k: v for k, v in new.items() if k != "attn"},
                              old, active)
        return {k: v if k == "attn" else rest[k] for k, v in new.items()}


class XLSTMDecodeState(DecodeStateSpec):
    """xLSTM carry: the sLSTM (c, n, m, h) scalar memories and the mLSTM
    matrix memory (C, n, m) of every pair, all O(1) in sequence length
    and f32, plus a per-row pos.  No leaf has a length axis, so a standby
    sync ships the whole row.  `decode` returns fresh tensors, so the
    base class's whole-tree `freeze` holds inactive rows."""

    def init_state(self, batch, max_len, dtype=None):
        st = _xlstm.init_cache(self.cfg, batch, max_len, dtype,
                               device=self.device)
        st["pos"] = torch.zeros((batch,), dtype=torch.int32,
                                device=self.device)
        return st

    def batch_axes(self):
        return {"slstm": (1, 1, 1, 1), "mlstm": (1, 1, 1), "pos": 0}

    def length_axes(self):
        return _tree_map(lambda _: -1, self.batch_axes())

    def decode(self, params, state, last):
        return _xlstm.decode_step(params, state, last, self.cfg)

    def prefill(self, params, state, tokens, lens, admit, page_ops=None):
        logits, fresh = _xlstm.prefill_cells(params, tokens, lens, self.cfg)
        return logits, admit_merge(state, fresh, self.batch_axes(), admit)


def paged_spec(spec: DecodeStateSpec, *, page_size: int,
               max_batch: int, max_len: int, pool_pages=None,
               prefix_entries: int = 0) -> PagedTransformerDecodeState:
    """Wrap a transformer KV spec's config in the paged-KV spec.  Carry
    families keep O(1) rows and have nothing to page."""
    if type(spec) is not TransformerDecodeState:
        raise ValueError(
            f"page_size > 0 requires a transformer KV family; "
            f"{type(spec).__name__} (state_kind={spec.state_kind!r}) "
            f"does not page")
    return PagedTransformerDecodeState(
        spec.cfg, page_size=page_size, max_batch=max_batch, max_len=max_len,
        pool_pages=pool_pages, prefix_entries=prefix_entries,
        device=spec.device)


_FAMILIES = {
    TransformerConfig: TransformerDecodeState,
    RGLRUConfig: RGLRUDecodeState,
    XLSTMConfig: XLSTMDecodeState,
}


def decode_spec(cfg, device="cuda") -> DecodeStateSpec:
    """Config dataclass -> its family's DecodeState spec."""
    for klass, spec in _FAMILIES.items():
        if isinstance(cfg, klass):
            return spec(cfg, device)
    raise KeyError(
        f"no decode-state family registered for config type "
        f"{type(cfg).__name__}; registered families: "
        f"{sorted(k.__name__ for k in _FAMILIES)}")
