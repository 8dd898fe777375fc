"""Continuous-batching serving engine on one device, in PyTorch.

A fixed pool of `max_batch` decode slots shares one decode state: a KV
cache (dense rows, or a paged pool) or a recurrent family's carries; the
family's DecodeState spec (`models/decode_state.py`) says how.  One
decode block runs `decode_block` sub-steps of decode -> sample ->
bookkeeping for every active slot with no host sync:
per-slot state (last token, budget, active / eos / temperature, the
request's PRNG stream) lives on the device, finished rows are masked out
inside the block, and the host drains the (B, N) token block with its
emit/done masks in one transfer.  On a CUDA device the sub-steps run under
`torch.cuda.set_sync_debug_mode("error")`, so an operation that would wait
for the device inside the block raises instead of stalling it.

Prefill is power-of-two length-bucketed and full-batch with an admit mask;
each row's first token is sampled on the device.

Determinism: each request owns a threefry stream (fold_in(seed,
submit_seq)) that advances once per decode sub-step, so outputs are the
same for any decode_block, slot placement, co-batched traffic or KV
layout (`serving/prng.py` reproduces jax's bits).

Co-residency: `swap_params` stages new params (cast once, as at
construction) and applies them at the first moment no request is in
flight; admissions are held meanwhile, so a request admitted under param
version v decodes its whole generation on v.

Migration (the serving plane, `serving/router.py`): `export_slots` and
`import_slots` move in-flight generations between engines on the same
param version bit-exactly: the bundle holds the slots' sampler state
(last token, budget, eos, temperature, PRNG stream) and their decode
state rows in the spec's wire format, so the resumed decode continues
the request's stream and kv length where the source stopped.
`export_delta` and `standby_apply` keep a warm standby of another
engine's slots in this engine's standby store; `promote_standby` resumes
one from it (a pointer flip) and `clear_rows` wipes rows whose
generations now live elsewhere.  Each is one pass of device ops over
full-width index vectors built on the host; on a CUDA device the vectors
go up from pinned memory without waiting and the ops run under sync
debug mode "error", so replication never blocks the host.

Compiled variants: `trace_count()` counts the distinct input signatures
(shapes, dtypes and non-tensor arguments, read on the host) that the
seven device entry points have been called with, the variants a jit
compiles in the reference and a CUDA-graph capture would need here.
Power-of-two prefill buckets keep it at len(buckets) + 1 for serving,
flat across waves, swaps and migrations.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models import decode_state as ds
from repro_torch.sync import no_host_sync
from repro_torch.train.tree import tree_map, tree_paths

from . import prng


@dataclass
class Request:
    """One generation request.

    Fields:
      uid: caller-chosen id, echoed back on the finished request.
      prompt: (S,) int32 token ids; S must be < EngineConfig.max_len.
      max_new_tokens: decode budget.
      temperature: 0 = greedy argmax; > 0 samples top-k at this
        temperature from the request's own PRNG stream.
      eos_id: stop token (None = budget/max_len only).
      arch: arch-group label (a model config name) on a mixed
        ConstellationRouter plane; None = the plane's default group.
        A bare ServingEngine ignores it.
      generated: output token ids (filled in by the engine).
      done: set once the request left its slot.
    """
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    eos_id: Optional[int] = None
    arch: Optional[str] = None
    # outputs
    generated: list = field(default_factory=list)
    done: bool = False
    # engine-internal: submission order, keys the request's PRNG stream
    _seq: int = -1
    # engine-internal: params_version the request was admitted (and will
    # decode its whole generation) under
    _params_version: int = -1


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs (the reference's, field for field).

    Fields:
      max_batch: decode-slot count, also the prefill batch.
      max_len: KV length per slot; prompt + generated tokens are cut to it.
      top_k: sampling pool size for temperature > 0 requests.
      seed: base PRNG key; each request's stream is
        fold_in(seed, submit_order).
      decode_block: tokens decoded per device block and host round-trip.
      min_bucket: smallest power-of-two prefill bucket.
      page_size: 0 = dense per-slot KV rows; > 0 = paged pool.
      pool_pages: physical page-pool size (paged only); None sizes it
        dense-equivalent.  Admission gates on free pages.
      prefix_cache: prefix-cache entries (paged only; 0 = off).
    """
    max_batch: int = 8
    max_len: int = 512
    top_k: int = 50
    seed: int = 0
    decode_block: int = 8
    min_bucket: int = 16
    page_size: int = 0
    pool_pages: Optional[int] = None
    prefix_cache: int = 0

    def __post_init__(self):
        if self.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, "
                             f"got {self.decode_block}")
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, "
                             f"got {self.min_bucket}")
        if self.page_size < 0:
            raise ValueError(f"page_size must be >= 0, "
                             f"got {self.page_size}")
        if not self.page_size and self.pool_pages is not None:
            raise ValueError("pool_pages requires page_size > 0")
        if not self.page_size and self.prefix_cache:
            raise ValueError("prefix_cache requires page_size > 0 "
                             "(prefix sharing is page-granular)")


# Enforced by `python -m repro_torch.analysis.lint --budgets` (entry
# "engine-serve"): the decode block and every prefill bucket run with
# zero host syncs (the reference's host callbacks) and zero collectives
# (decode is pod-local), and decode + prefill stay within the pow2
# bucket count of compiled variants.
LINT_BUDGET = {
    "host_callbacks": 0,
    "decode_collective_wire_bytes": 0,
    "max_traces": 4,  # 3 prefill buckets (16/32/64 at max_len 64) + decode
}


def _signature(x):
    """A call argument's part of an input signature: a tensor's shape and
    dtype, a container's keys and items, any other value itself.  Read
    on the host: no device access."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return x


def _device_entry(fn):
    """Record each distinct input signature of a device entry point
    (`ServingEngine.trace_count`)."""
    @functools.wraps(fn)
    def wrapper(self, *args):
        self._variants.add((fn.__name__, _signature(args)))
        return fn(self, *args)
    return wrapper


def check_swap_compatible(old_params, new_params):
    """Raise unless `new_params` can replace `old_params` in place: the
    same tree of names, and every leaf of the same shape and dtype (so
    every kernel runs at the shapes it ran at before).  Both trees must
    be of the same kind: the engine compares the params it was built
    from (kept as meta tensors) with the uncast params of a swap."""
    old, new = tree_paths(old_params), tree_paths(new_params)
    if list(old) != list(new):
        raise ValueError(f"swap_params: tree structure mismatch "
                         f"({sorted(set(old) ^ set(new))} differ)")
    for name, o in old.items():
        n = new[name]
        if tuple(o.shape) != tuple(n.shape) or o.dtype != n.dtype:
            raise ValueError(
                f"swap_params: leaf {name} mismatch {tuple(n.shape)}/"
                f"{n.dtype} != {tuple(o.shape)}/{o.dtype} — a swap must "
                f"keep every shape and dtype")


class ServingEngine:
    """Serves `Request`s on the device that holds `params`."""

    def __init__(self, cfg, fns, params, ecfg: EngineConfig):
        self.model_cfg = cfg
        self.ecfg = ecfg
        self.device = params["embed"].device
        self._cast = fns.cast_params
        self._template = tree_map(
            lambda x: torch.empty_like(x, device="meta"), params)
        self.params = fns.cast_params(params, cfg)
        self.params_version = 0
        self._pending_params = None
        self.spec = fns.decode_spec(cfg, self.device)
        if ecfg.page_size:
            self.spec = ds.paged_spec(
                self.spec, page_size=ecfg.page_size,
                max_batch=ecfg.max_batch, max_len=ecfg.max_len,
                pool_pages=ecfg.pool_pages,
                prefix_entries=ecfg.prefix_cache)
        self.cache = self.spec.init_state(ecfg.max_batch, ecfg.max_len)
        b, dev = ecfg.max_batch, self.device
        self.state = {
            "last": torch.zeros((b,), dtype=torch.int32, device=dev),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
            "remaining": torch.zeros((b,), dtype=torch.int32, device=dev),
            "temp": torch.zeros((b,), dtype=torch.float32, device=dev),
            "eos": torch.full((b,), -1, dtype=torch.int32, device=dev),
            "rkey": torch.zeros((b, 2), dtype=torch.int64, device=dev),
        }
        self._state_axes = {k: 0 for k in self.state}   # all slot-major
        self._base_key = prng.PRNGKey(ecfg.seed, dev)
        self._next_seq = 0
        self.slots: list[Optional[Request]] = [None] * b
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.standby = None          # warm-standby store, made on demand
        self._variants: set = set()  # (entry point, input signature)
        self.stats = {"tokens": 0, "host_syncs": 0, "decode_blocks": 0,
                      "swaps": 0, "exported_slots": 0, "imported_slots": 0,
                      "standby_syncs": 0, "promoted_slots": 0}
        # host-side conservative page accounting (paged only): admission
        # reserves worst-case pages per request so the device allocator's
        # free stack never underflows.  device free >= _pool_free >= 0.
        self._pool_free = getattr(self.spec, "pool_pages", 0)
        self._reserved: dict[int, tuple[int, int]] = {}  # slot -> (pages, pinned)
        self._prefix_index: dict[bytes, tuple[int, int]] = {}
        self._prefix_staged: dict[bytes, tuple[int, int]] = {}
        self._next_prefix_entry = 0
        if ecfg.page_size:
            self.stats.update(pages_reserved=0, pages_shared=0,
                              prefix_hits=0, prefix_stores=0,
                              admission_stalls=0)

    # --- bucketing ---------------------------------------------------------
    def buckets(self) -> list[int]:
        """Power-of-two prefill bucket lengths up to max_len."""
        out, b = [], self.ecfg.min_bucket
        while b < self.ecfg.max_len:
            out.append(b)
            b *= 2
        out.append(self.ecfg.max_len)
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets():
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_len "
                         f"{self.ecfg.max_len}")

    # --- device-side sampling ---------------------------------------------
    def _sample(self, logits, keys, temps):
        """Per-row top-k temperature sampling (greedy where temp == 0);
        row b draws from its own stream keys[b]."""
        greedy = torch.argmax(logits, dim=-1)
        k = min(self.ecfg.top_k, logits.shape[-1])
        vals, idx = torch.topk(logits, k, dim=-1)
        scaled = vals / torch.clamp_min(temps[:, None], 1e-6)
        draw = prng.categorical(keys, scaled)
        sampled = torch.gather(idx, 1, draw[:, None])[:, 0]
        return torch.where(temps > 0, sampled, greedy).to(torch.int32)

    # --- the decode block (the hot path) ----------------------------------
    @_device_entry
    def _engine_step_impl(self, params, cache, state):
        """Decode up to N tokens for every active slot, with no host sync.

        Each sub-step: spec.advance (paged: map a page for rows crossing a
        page boundary) -> spec.decode -> per-row sample -> masked
        bookkeeping -> spec.release (paged: finished rows' pages go back
        on the free stack).  Inactive rows hold their pos (their stale KV
        writes land in the masked tail, or the trash page) and their PRNG
        stream."""
        max_len = self.ecfg.max_len
        toks, emits, dones = [], [], []
        st = state
        for _ in range(self.ecfg.decode_block):
            was = st["active"]
            cache = self.spec.advance(cache, was)
            logits, cache2 = self.spec.decode(params, cache,
                                              st["last"][:, None])
            pair = prng.split(st["rkey"])
            tok = self._sample(logits, pair[:, 1], st["temp"])
            tok = torch.where(was, tok, st["last"])
            cache2 = self.spec.freeze(cache2, cache, was)
            remaining = st["remaining"] - was.to(torch.int32)
            done = was & ((tok == st["eos"]) | (remaining <= 0)
                          | (cache2["pos"] + 1 >= max_len))
            cache = self.spec.release(cache2, done)
            st = {"last": tok, "active": was & ~done,
                  "remaining": remaining, "temp": st["temp"],
                  "eos": st["eos"],
                  "rkey": torch.where(was[:, None], pair[:, 0], st["rkey"])}
            toks.append(tok)
            emits.append(was)
            dones.append(done)
        return (cache, st, torch.stack(toks, 1), torch.stack(emits, 1),
                torch.stack(dones, 1))                  # (B, N) each

    # --- bucketed prefill --------------------------------------------------
    @_device_entry
    def _prefill_impl(self, params, cache, state, tokens, lens, admit,
                      temps, eos, budgets, seqs, page_ops):
        """Prefill `admit`-masked rows of a (max_batch, bucket) block into
        the shared cache and sample each row's first token."""
        logits, new_cache = self.spec.prefill(params, cache, tokens, lens,
                                              admit, page_ops=page_ops)
        rkeys = prng.fold_in(self._base_key.expand(seqs.shape[0], 2), seqs)
        pair = prng.split(rkeys)
        first = self._sample(logits, pair[:, 1], temps)
        done0 = admit & ((first == eos) | (budgets <= 1)
                         | (lens + 1 >= self.ecfg.max_len))
        new_cache = self.spec.release(new_cache, done0)

        def sel(new, old):
            return torch.where(admit if new.dim() == 1 else admit[:, None],
                               new, old)
        new_state = {
            "last": sel(first, state["last"]),
            "active": torch.where(admit, ~done0, state["active"]),
            "remaining": sel(budgets - 1, state["remaining"]),
            "temp": sel(temps, state["temp"]),
            "eos": sel(eos, state["eos"]),
            "rkey": sel(pair[:, 0], state["rkey"]),
        }
        return new_cache, new_state, first, done0

    # --- slot migration (the serving plane) --------------------------------
    @_device_entry
    def _export_impl(self, cache, state, idx, drop):
        """Gather rows `idx` of the slot state and the decode state (in the
        spec's wire format) into fresh tensors; deactivate `drop`-masked
        rows on the source, which hand their pages back (paged)."""
        bundle_cache = self.spec.export_rows(cache, idx)
        bundle_state = ds.state_rows(state, self._state_axes, idx)
        new_state = {**state, "active": state["active"] & ~drop}
        return (bundle_cache, bundle_state, self.spec.release(cache, drop),
                new_state)

    @_device_entry
    def _import_impl(self, cache, state, bcache, bstate, src_for_dst, mask):
        """Scatter bundle rows into `mask`-ed slots; row d takes bundle row
        `src_for_dst[d]`.  Unmasked rows are untouched."""
        return (self.spec.import_rows(cache, bcache, src_for_dst, mask),
                ds.merge_rows(state, bstate, self._state_axes, src_for_dst,
                              mask))

    def export_slots(self, slot_ids) -> dict:
        """Take the in-flight generations in `slot_ids` off this engine.

        Returns a bundle of their device state (fresh tensors: the source
        may go on decoding its other slots), the Request objects, the
        params_version and max_len.  The slots are freed.  No device read."""
        slot_ids = list(slot_ids)
        if not slot_ids:
            raise ValueError("export_slots: empty slot list")
        b = self.ecfg.max_batch
        idx = np.zeros((b,), np.int32)
        drop = np.zeros((b,), bool)
        reqs = []
        for j, s in enumerate(slot_ids):
            req = self.slots[s]
            if req is None:
                raise ValueError(f"export_slots: slot {s} is empty")
            idx[j] = s
            drop[s] = True
            reqs.append(req)
        idx, drop = self._to_device(idx), self._to_device(drop)
        with no_host_sync(self.device):
            bcache, bstate, self.cache, self.state = self._export_impl(
                self.cache, self.state, idx, drop)
        for s in slot_ids:
            self.slots[s] = None
            self._return_pages(s)
        self.stats["exported_slots"] += len(reqs)
        return {"cache": bcache, "state": bstate, "requests": reqs,
                "params_version": self.params_version,
                "max_len": self.ecfg.max_len}

    def import_slots(self, bundle) -> list[int]:
        """Resume a bundle of exported generations in this engine's free
        slots; returns their slot ids.  The engine must serve the param
        version the requests were admitted under and share max_len (the
        row length); a mismatch raises rather than mixing snapshots."""
        if bundle["max_len"] != self.ecfg.max_len:
            raise ValueError(
                f"import_slots: max_len mismatch {bundle['max_len']} != "
                f"{self.ecfg.max_len} — replicas must share the KV layout")
        if bundle["params_version"] != self.params_version:
            raise ValueError(
                f"import_slots: param snapshot mismatch (bundle v"
                f"{bundle['params_version']} != engine v"
                f"{self.params_version}) — a migrated generation must "
                "resume on its admission snapshot")
        reqs = bundle["requests"]
        free = [i for i, s in enumerate(self.slots) if s is None]
        if len(free) < len(reqs):
            raise ValueError(f"import_slots: {len(reqs)} rows but only "
                             f"{len(free)} free slots")
        dst_slots = free[:len(reqs)]
        self._reserve_for_resume(dst_slots, reqs)
        self._resume(bundle["cache"], bundle["state"],
                     list(enumerate(dst_slots)))
        for d, req in zip(dst_slots, reqs):
            self.slots[d] = req
        self.stats["imported_slots"] += len(reqs)
        return dst_slots

    def _resume(self, bcache, bstate, placements):
        """One import pass: bundle row j lands in slot d for each (j, d)."""
        b = self.ecfg.max_batch
        src = np.zeros((b,), np.int32)
        mask = np.zeros((b,), bool)
        for j, d in placements:
            src[d] = j
            mask[d] = True
        src, mask = self._to_device(src), self._to_device(mask)
        with no_host_sync(self.device):
            self.cache, self.state = self._import_impl(
                self.cache, self.state, bcache, bstate, src, mask)

    # --- warm-standby replication ------------------------------------------
    @_device_entry
    def _delta_export_impl(self, cache, state, idx, starts, width):
        """Each `idx` slot's delta: windowed leaves at [starts, starts +
        width) from the replication cursor, carry leaves whole, plus its
        sampler state row."""
        return (self.spec.export_delta_rows(cache, idx, starts, width),
                ds.state_rows(state, self._state_axes, idx))

    @_device_entry
    def _standby_apply_impl(self, sb_cache, sb_state, bcache, bstate,
                            src_for_dst, starts, mask):
        """Scatter a delta bundle into `mask`-ed standby rows; the standby
        pos tracks the replication cursor."""
        return (self.spec.apply_delta_rows(sb_cache, bcache, src_for_dst,
                                           starts, mask),
                ds.merge_rows(sb_state, bstate, self._state_axes,
                              src_for_dst, mask))

    @_device_entry
    def _deactivate_impl(self, cache, state, drop):
        return (self.spec.release(cache, drop),
                {**state, "active": state["active"] & ~drop})

    def ensure_standby(self):
        """Allocate the warm-standby store (a full-width mirror of the slot
        state and decode state, in the wire format) on first use."""
        if self.standby is None:
            self.standby = {
                "cache": self.spec.init_standby(self.cache),
                "state": {k: torch.zeros_like(v)
                          for k, v in self.state.items()}}

    def export_delta(self, entries, width: int) -> dict:
        """Delta-export `entries` = [(slot, cursor), ...]: each slot's
        state delta [cursor, cursor + width) (a carry family's whole
        state) and its sampler row.  Nothing is deactivated: this is the
        background replication feed, off the decode path."""
        b = self.ecfg.max_batch
        if not 0 < len(entries) <= b:
            raise ValueError(f"export_delta: {len(entries)} entries for "
                             f"{b} slots")
        idx = np.zeros((b,), np.int32)
        starts = np.zeros((b,), np.int32)
        for j, (s, c) in enumerate(entries):
            if self.slots[s] is None:
                raise ValueError(f"export_delta: slot {s} is empty")
            idx[j] = s
            starts[j] = c
        idx_d, starts_d = self._to_device(idx), self._to_device(starts)
        with no_host_sync(self.device):
            bcache, bstate = self._delta_export_impl(
                self.cache, self.state, idx_d, starts_d, int(width))
        return {"cache": bcache, "state": bstate, "starts": starts,
                "params_version": self.params_version,
                "max_len": self.ecfg.max_len}

    def standby_apply(self, bundle, placements):
        """Apply a delta bundle to this engine's standby store;
        `placements` = [(bundle_row, standby_row), ...].  The bundle must
        come from an engine on the same params and max_len: a standby is
        only ever promoted into this engine."""
        if bundle["max_len"] != self.ecfg.max_len:
            raise ValueError(
                f"standby_apply: max_len mismatch {bundle['max_len']} != "
                f"{self.ecfg.max_len}")
        if bundle["params_version"] != self.params_version:
            raise ValueError(
                f"standby_apply: param snapshot mismatch (bundle v"
                f"{bundle['params_version']} != engine v"
                f"{self.params_version})")
        self.ensure_standby()
        b = self.ecfg.max_batch
        src = np.zeros((b,), np.int32)
        starts = np.zeros((b,), np.int32)
        mask = np.zeros((b,), bool)
        for j, r in placements:
            src[r] = j
            starts[r] = bundle["starts"][j]
            mask[r] = True
        dev = self._to_device
        src, starts, mask = dev(src), dev(starts), dev(mask)
        with no_host_sync(self.device):
            sc, ss = self._standby_apply_impl(
                self.standby["cache"], self.standby["state"],
                bundle["cache"], bundle["state"], src, starts, mask)
        self.standby = {"cache": sc, "state": ss}
        self.stats["standby_syncs"] += 1

    def promote_standby(self, pairs) -> list[int]:
        """Pointer-flip failover: resume `pairs` = [(standby_row, Request),
        ...] from this engine's own standby store into its free slots, by
        the import pass.  The caller promotes only fresh standbys (cursor
        at the source's pos, state synced after its last decode block):
        then the continuation is bit-identical."""
        if self.standby is None:
            raise ValueError("promote_standby: no standby store")
        reqs = [r for _, r in pairs]
        free = [i for i, s in enumerate(self.slots) if s is None]
        if len(free) < len(reqs):
            raise ValueError(f"promote_standby: {len(reqs)} rows but only "
                             f"{len(free)} free slots")
        dst_slots = free[:len(reqs)]
        self._reserve_for_resume(dst_slots, reqs)
        self._resume(self.standby["cache"], self.standby["state"],
                     [(row, d) for (row, _), d in zip(pairs, dst_slots)])
        for d, req in zip(dst_slots, reqs):
            self.slots[d] = req
        self.stats["promoted_slots"] += len(reqs)
        return dst_slots

    def clear_rows(self, slot_ids):
        """Deactivate device rows whose generations now live elsewhere
        (pointer-flipped away, or shed)."""
        drop = np.zeros((self.ecfg.max_batch,), bool)
        for s in slot_ids:
            drop[s] = True
            self._return_pages(s)
        drop = self._to_device(drop)
        with no_host_sync(self.device):
            self.cache, self.state = self._deactivate_impl(
                self.cache, self.state, drop)

    # --- host-side page accounting (paged layout only) ---------------------
    @property
    def _paged(self) -> bool:
        return bool(self.ecfg.page_size)

    def _return_pages(self, slot: int):
        """A slot left the engine (finished, exported, cleared): its
        worst-case reservation, minus pages pinned in the prefix cache,
        goes back to the host's free-page count."""
        if not self._paged:
            return
        reserve, pinned = self._reserved.pop(slot, (0, 0))
        self._pool_free += reserve - pinned

    def _reserve_for_resume(self, dst_slots, reqs):
        """Reserve pages for rows arriving by import or promotion: every
        page the resumed generation can still touch.  Raises if the pool
        cannot cover it (the caller keeps the bundle)."""
        if not self._paged:
            return
        ps = self.ecfg.page_size
        plans = []
        for req in reqs:
            kv = len(req.prompt) + len(req.generated)
            left = req.max_new_tokens - len(req.generated)
            plans.append(-(-min(kv + max(left, 0), self.ecfg.max_len) // ps))
        if sum(plans) > self._pool_free:
            raise ValueError(
                f"import: {sum(plans)} pages needed but only "
                f"{self._pool_free} free in the pool")
        for d, need in zip(dst_slots, plans):
            self._reserved[d] = (need, 0)
            self._pool_free -= need
            self.stats["pages_reserved"] += need

    def _page_plan(self, req: Request):
        """Host half of paged admission: worst-case page reservation and
        the prefix-cache plan.  Returns (reserve, pinned, ops) with ops =
        (pf_entry, pf_n, pf_store, pf_store_n), or None if the pool cannot
        cover the reservation now.

        Prefix matching is whole-page, longest match over published
        entries (entries staged in this same fill become matchable from
        the next fill).  A complete miss publishes the prompt's whole-page
        head while entries remain; its pinned pages are paid for by this
        request's reservation and never returned."""
        ps = self.ecfg.page_size
        s = len(req.prompt)
        total = -(-min(s + req.max_new_tokens, self.ecfg.max_len) // ps)
        prompt = np.asarray(req.prompt, np.int32)
        entry, shared = -1, 0
        store, store_n = -1, 0
        if self.ecfg.prefix_cache:
            for j in range(s // ps, 0, -1):
                hit = self._prefix_index.get(prompt[:j * ps].tobytes())
                if hit is not None:
                    entry, shared = hit[0], j
                    self.stats["prefix_hits"] += 1
                    break
            j_store = s // ps
            if entry < 0 and j_store > 0 and \
                    self._next_prefix_entry < self.ecfg.prefix_cache and \
                    prompt[:j_store * ps].tobytes() not in self._prefix_staged:
                # a head staged by an earlier row of this fill is being
                # published by that row: do not spend a second entry
                store = self._next_prefix_entry
                store_n = j_store
                self._next_prefix_entry += 1
                for j in range(1, j_store + 1):
                    key = prompt[:j * ps].tobytes()
                    if key not in self._prefix_index and \
                            key not in self._prefix_staged:
                        self._prefix_staged[key] = (store, j)
                self.stats["prefix_stores"] += 1
        reserve = total - shared
        if reserve > self._pool_free:
            # roll back the store claim; the request stays queued
            if store >= 0:
                self._next_prefix_entry -= 1
                self._prefix_staged = {
                    k: v for k, v in self._prefix_staged.items()
                    if v[0] != store}
                self.stats["prefix_stores"] -= 1
            if entry >= 0:
                self.stats["prefix_hits"] -= 1
            return None
        pinned = store_n if store >= 0 else 0
        self.stats["pages_reserved"] += reserve
        self.stats["pages_shared"] += shared
        return reserve, pinned, (entry, shared, store, store_n)

    def page_stats(self) -> dict:
        """Paged-pool occupancy: the host's conservative view and the
        device allocator's live-page count (one device read: a
        diagnostics call, not the hot path)."""
        if not self._paged:
            return {}
        live = int(self.spec.live_pages(self.cache).item())
        return {"pool_pages": self.spec.pool_pages,
                "host_free": self._pool_free,
                "device_live": live,
                "page_size": self.ecfg.page_size,
                "prefix_entries_used": self._next_prefix_entry}

    # --- host-side slot management ----------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) >= self.ecfg.max_len:
            # == max_len too: the row would be full with no room to decode
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} "
                f"must be < max_len {self.ecfg.max_len} (a prompt that "
                f"fills the whole cache row leaves no room to decode)")
        if req._seq < 0:
            req._seq = self._next_seq
            self._next_seq += 1
        self.queue.append(req)

    def _to_device(self, a):
        """A host array on the engine's device; on CUDA from pinned memory
        without waiting for the device (no stream sync)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fill_slots(self):
        """Admit queued requests into free slots via bucketed prefill.

        Paged layout: admission also gates on free pages, FIFO: a head
        request that does not fit stalls admission until a decode block
        recycles enough pages."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        admitted = []
        while free and self.queue:
            if self._paged:
                plan = self._page_plan(self.queue[0])
                if plan is None:
                    self.stats["admission_stalls"] += 1
                    break
                slot = free.pop(0)
                self._reserved[slot] = plan[:2]
                self._pool_free -= plan[0]
                admitted.append((slot, self.queue.pop(0), plan[2]))
            else:
                admitted.append((free.pop(0), self.queue.pop(0), None))
        if not admitted:
            return
        groups = defaultdict(list)
        for slot, req, ops in admitted:
            groups[self._bucket_for(len(req.prompt))].append(
                (slot, req, ops))

        b = self.ecfg.max_batch
        results = []
        for lb in sorted(groups):
            grp = groups[lb]
            tokens = np.zeros((b, lb), np.int32)
            lens = np.zeros((b,), np.int32)
            admit = np.zeros((b,), bool)
            temps = np.zeros((b,), np.float32)
            eos = np.full((b,), -1, np.int32)
            budgets = np.ones((b,), np.int32)
            seqs = np.zeros((b,), np.int32)
            page_ops = {"pf_entry": np.full((b,), -1, np.int32),
                        "pf_n": np.zeros((b,), np.int32),
                        "pf_store": np.full((b,), -1, np.int32),
                        "pf_store_n": np.zeros((b,), np.int32)}
            for slot, req, ops in grp:
                req._params_version = self.params_version
                tokens[slot, :len(req.prompt)] = req.prompt
                lens[slot] = len(req.prompt)
                admit[slot] = True
                temps[slot] = req.temperature
                eos[slot] = -1 if req.eos_id is None else req.eos_id
                budgets[slot] = req.max_new_tokens
                seqs[slot] = req._seq
                self.slots[slot] = req
                if ops is not None:
                    (page_ops["pf_entry"][slot], page_ops["pf_n"][slot],
                     page_ops["pf_store"][slot],
                     page_ops["pf_store_n"][slot]) = ops
            dev = self._to_device
            self.cache, self.state, first, done0 = self._prefill_impl(
                self.params, self.cache, self.state, dev(tokens), dev(lens),
                dev(admit), dev(temps), dev(eos), dev(budgets), dev(seqs),
                {k: dev(v) for k, v in page_ops.items()})
            results.append((grp, first, done0))
        # prefix entries published by the calls above are now resident
        if self._prefix_staged:
            self._prefix_index.update(self._prefix_staged)
            self._prefix_staged.clear()

        # one transfer for all admission rounds of this fill
        flat = torch.stack([torch.stack([f, d.to(torch.int32)])  # repro-lint: allow[HS001] the single batched admission drain; counted in stats["host_syncs"]
                            for _, f, d in results]).cpu().numpy()
        self.stats["host_syncs"] += 1
        for (grp, _, _), (first, done0) in zip(results, flat):
            for slot, req, _ in grp:
                req.generated.append(int(first[slot]))
                self.stats["tokens"] += 1
                if done0[slot]:
                    req.done = True
                    self.finished.append(req)
                    self.slots[slot] = None
                    self._return_pages(slot)

    def _decode_block(self):
        """One decode block on the device; drain it in a single transfer."""
        with no_host_sync(self.device):
            self.cache, self.state, toks, emit, done = \
                self._engine_step_impl(self.params, self.cache, self.state)
            block = torch.stack([toks, emit.to(torch.int32),
                                 done.to(torch.int32)])
        toks, emit, done = block.cpu().numpy()  # repro-lint: allow[HS001] the per-block drain: one transfer per decode block, counted in stats["host_syncs"]
        emit, done = emit.astype(bool), done.astype(bool)
        self.stats["host_syncs"] += 1
        self.stats["decode_blocks"] += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            row = toks[i][emit[i]]
            req.generated.extend(int(t) for t in row)
            self.stats["tokens"] += int(emit[i].sum())
            if done[i].any():
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self._return_pages(i)

    # --- param hot-swap (serving/training co-residency) --------------------
    def swap_params(self, new_params):
        """Stage `new_params` as the next params to serve from.

        They must match the names, shapes and dtypes of the params the
        engine was built from, and are cast as the constructor casts.
        The swap applies at the next moment no request is in flight
        (`step` holds admissions while a swap is pending, so active slots
        drain): a request admitted under version v decodes its whole
        generation on v.  Applying it is a reference assignment — no
        cache reset, no device sync.  Staging twice before the swap
        applies keeps only the newest params.  Returns the version the
        new params will serve under."""
        check_swap_compatible(self._template, new_params)
        self._pending_params = self._cast(new_params, self.model_cfg)
        self._maybe_apply_swap()
        return self.params_version + (self._pending_params is not None)

    def _maybe_apply_swap(self):
        """Apply a staged swap once no generation is in flight."""
        if self._pending_params is not None and \
                all(s is None for s in self.slots):
            self.params = self._pending_params
            self._pending_params = None
            self.params_version += 1
            self.stats["swaps"] += 1

    def step(self):
        """Admit new requests, then decode one block for all active slots.
        Returns the number of active slots decoded this block.

        While a param swap is staged, admission is held so the in-flight
        generations drain on their own params; the swap applies at the
        first empty-slot boundary and admission resumes under the new
        version."""
        self._maybe_apply_swap()
        if self._pending_params is None:
            self._fill_slots()
        n_active = sum(s is not None for s in self.slots)
        if n_active:
            self._decode_block()
            self._maybe_apply_swap()   # the block may have drained the pool
        return n_active

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def trace_count(self, *entries: str) -> int:
        """Distinct input signatures the device entry points have run
        with: the variants the reference's jit compiles, and a graph
        capture would need.  `entries` (method names such as
        "_prefill_impl") restricts the count to those."""
        return sum(1 for name, _ in self._variants
                   if not entries or name in entries)
