"""Tuple-space serving plane: a partitioned, replicated session space
across N serving pods (the Space-Based Architecture pattern, applied to
the constellation).

One `ServingEngine` per serving pod, fronted by a `ConstellationRouter`.
The router admits requests only to pods the liveness feed marks alive
(`ConstellationLinkModel.serving_mask`: a pod masked for training is
masked for serving at the same round) and survives restart-class
outages without a full drain on the critical path:

- **Partitioning.** A hash of `Request.uid` picks each session's home
  pod; admission prefers it while it is alive with capacity, else spills
  by smooth weighted round-robin over the bandwidth-proportional
  admission weights.  Placement never changes a request's tokens.
- **Warm standbys.** Every in-flight slot keeps a replica of its state
  on a liveness-chosen neighbour pod (`choose_standby_pod`), kept by
  incremental background replication: each tick ships only the KV rows
  written since the last sync (`export_delta`, one gather per (source,
  standby) pair) plus the per-slot sampler row, with no host sync.
- **Pointer-flip failover.** When a pod's mask drops, each of its slots
  whose standby is fresh (cursor at the source's kv pos, state synced
  after its last decode block) resumes by promoting that standby row
  into a free slot of the standby pod: no export from the dead pod, and
  the continuation is bit-identical to an uninterrupted single-engine
  run.  Slots without a usable standby fall back to a full
  `export_slots`/`import_slots` drain; slots with no capacity anywhere
  are deferred (frozen on the masked pod, aged, retried) and past
  `GridConfig.defer_deadline` the router raises, or sheds with a stat.
- **Rebalance.** When a pod rejoins, sessions move back (at most
  one per tick, home pods first, by pointer flip where
  the standby already lives on the destination) until occupancy matches
  the largest-remainder quota of the admission weights.
- **Reservation.** A deferred session with a fresh standby reserves a
  slot on its standby pod; admission and rebalance never take it.

Fault injection is an input: `forced_outage` takes a single-strike
`ForcedOutage` or a `ChaosSchedule` (serving/chaos.py) of repeated
multi-pod strike and repair cycles.

Param swaps are plane-wide and in lockstep: `swap_params` stages at the
router, holds admissions, lets every in-flight generation drain
(migrations included), then swaps every replica of the arch group at
once, so a standby or a migration never crosses param versions.

**Mixed planes.** Replicas are grouped by model config name into arch
groups: a request lands in its arch's group (`Request.arch`, None = the
default group), and home hashing, spill, standby placement, failover
drains and rebalance quotas all stay inside the group.  The replication
cursor follows each group's `DecodeStateSpec.windowed`: KV groups ship
`repl_chunk`-row deltas, carry groups their whole O(window) state, fresh
after every sync.

Port notes.  The reference's two deliberate host waits, which time a
failover stall with the device work on both of its edges, are
`torch.cuda.synchronize(device)` here and nothing on the CPU.
`trace_count()` sums the engines' compiled variants (input signatures of
their device entry points), as the reference sums its jit traces.  Each
request's PRNG `_seq` is assigned here, so its stream is the same on
every pod.
"""
from __future__ import annotations

import time
from bisect import insort
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.isl.liveness import (choose_standby_pod,
                                 normalize_admission_weights)
from .chaos import ChaosSchedule, as_chaos_schedule
from .engine import Request, ServingEngine, check_swap_compatible

# sessions background rebalancing moves per router tick
_REBALANCE_PER_TICK = 1

# Enforced by `python -m repro_torch.analysis.lint --budgets` (entry
# "engine-serve" runs the export/import migration and the replication
# entry points the router's failover path drives): bit-exact slot
# migration runs with zero host syncs; the only host waits in `step()`
# are the suppressed stall-measurement ones (see the lint baseline).
LINT_BUDGET = {"host_callbacks": 0}


@dataclass(frozen=True)
class ForcedOutage:
    """Deterministic single-strike fault injection (see serving/chaos.py
    for full schedules; the router converts this to a one-event
    `ChaosSchedule`).

    Fields:
      at_tick: earliest router tick at which the outage strikes.
      pod: pod index to strike; None = the pod with the most in-flight
        slots at strike time (guarantees the outage actually exercises
        failover), ties broken toward the lowest index. With pod=None
        the strike is deferred past `at_tick` until some pod has
        in-flight work — striking an idle plane would exercise nothing.
      ticks: outage duration in router ticks from the actual strike;
        None = rest of the run.
    """
    at_tick: int
    pod: Optional[int] = None
    ticks: Optional[int] = None


@dataclass(frozen=True)
class GridConfig:
    """Session-grid knobs.

    Fields:
      replicate: maintain warm standbys (needs >= 2 pods; off = the
        drain-only plane, every failover a full export and import).
      repl_chunk: KV rows shipped per slot per replication tick; None =
        max_len (a standby catches up in one tick). Smaller chunks bound
        per-tick replication bandwidth; a standby is simply not
        promotable until its cursor catches up.
      defer_deadline: max ticks a slot may sit deferred (frozen on a
        masked pod with no capacity anywhere) before the router raises;
        None = wait forever (invisible starvation).
      shed_on_deadline: past the deadline, drop the request (recorded in
        `dropped_deferred` + `router.dropped`) instead of raising.
    """
    replicate: bool = True
    repl_chunk: Optional[int] = None
    defer_deadline: Optional[int] = 100
    shed_on_deadline: bool = False

    def __post_init__(self):
        if self.repl_chunk is not None and self.repl_chunk < 1:
            raise ValueError(f"repl_chunk must be >= 1, got "
                             f"{self.repl_chunk}")
        if self.defer_deadline is not None and self.defer_deadline < 1:
            raise ValueError(f"defer_deadline must be >= 1, got "
                             f"{self.defer_deadline}")


class _Session:
    """Router-side record of one in-flight generation."""
    __slots__ = ("req", "home", "pod", "slot", "sb_pod", "sb_row",
                 "cursor", "synced_len", "version", "defer_age")

    def __init__(self, req, home, pod, version):
        self.req = req
        self.home = home            # key-partition home pod
        self.pod = pod              # current primary pod
        self.slot = None            # primary slot (bound after prefill)
        self.sb_pod = None          # warm-standby pod
        self.sb_row = None          # standby row on sb_pod
        self.cursor = 0             # KV rows replicated so far
        self.synced_len = -1        # len(generated) at last caught-up sync
        self.version = version      # params_version (lockstep witness)
        self.defer_age = 0          # ticks spent frozen with nowhere to go


class ConstellationRouter:
    """Liveness-routed session grid over N ServingEngine replicas.

    mask_fn(t) -> (alive (n_pods,) bool, weights (n_pods,) float) is the
    liveness feed — `ConstellationLinkModel.serving_mask` via
    `liveness_mask_fn`, or None for an always-alive equal-weight plane.
    The tick passed to mask_fn is the router's own step counter unless
    `round_override` is set (launch/coserve.py pins it to the DiLoCo
    round index so training and serving read the SAME mask schedule).

    Duck-types the engine surface the launchers drive (`submit`, `step`,
    `run`, `queue`, `finished`, `slots`, `ecfg`, `swap_params`,
    `params_version`), so `run_coserve` works unchanged on a plane.
    """

    def __init__(self, engines, mask_fn: Optional[Callable] = None,
                 forced_outage=None, grid: Optional[GridConfig] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("ConstellationRouter needs >= 1 engine")
        if len({e.ecfg.max_len for e in engines}) != 1:
            raise ValueError("replicas must share max_len (migration "
                             "moves raw state rows between caches)")
        self.engines = engines
        self.n_pods = len(engines)
        # arch groups: pods hosting the same model config are mutual
        # migration/standby targets; sessions never cross groups
        self._group_of: list[int] = []
        self._groups: list[list[int]] = []
        self._group_label: list[str] = []
        self._group_by_label: dict[str, int] = {}
        for i, e in enumerate(engines):
            label = e.model_cfg.name
            g = self._group_by_label.get(label)
            if g is None:
                g = len(self._groups)
                self._group_by_label[label] = g
                self._groups.append([])
                self._group_label.append(label)
            self._group_of.append(g)
            self._groups[g].append(i)
        for g, pods in enumerate(self._groups):
            if len({engines[i].params_version for i in pods}) != 1:
                raise ValueError(
                    f"replicas of arch group {self._group_label[g]!r} "
                    f"must start on one param snapshot")
        self.mask_fn = mask_fn
        self.chaos: Optional[ChaosSchedule] = as_chaos_schedule(forced_outage)
        self._chaos_state: dict = {}
        self.grid = grid or GridConfig()
        self._replicating = self.grid.replicate and self.n_pods >= 2
        self.tick = 0
        self.round_override: Optional[int] = None
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.dropped: list[Request] = []
        self._next_seq = 0
        self._credits = np.zeros(self.n_pods)
        self._pending_params: dict[int, object] = {}   # by arch group
        self._last_alive = None
        self._sessions: dict[int, _Session] = {}       # by Request._seq
        self._sb_free = [list(range(e.ecfg.max_batch)) for e in engines]
        # rows to wipe when their pod rejoins
        self._pending_clear = [set() for _ in engines]
        self._reserved = np.zeros(self.n_pods, int)
        self._wire_bytes_cache: dict[int, tuple] = {}
        self._last_weights = np.full(self.n_pods, 1.0 / self.n_pods)
        # wall seconds of each tick's failover phase that moved >= 1 slot,
        # device work forced to completion on both edges so a pointer flip
        # (import-only) and a full drain (export + import) are comparable
        self.failover_stalls: list[float] = []
        self.stats = {
            "migrations": 0, "migrated_slots": 0,
            "pointer_flips": 0, "full_migrations": 0,
            "rebalances": 0, "rebalanced_slots": 0,
            "deferred_slot_migrations": 0, "requeued": 0,
            "masked_pod_ticks": 0, "mask_transitions": 0, "rejoins": 0,
            "swaps": 0,
            "admitted_per_pod": [0] * self.n_pods,
            "admitted_home": 0, "admitted_spill": 0,
            "standby_seeded": 0, "standby_rehomed": 0,
            "replication_syncs": 0, "replicated_rows": 0,
            "full_rows_equiv": 0,
            "replicated_bytes": 0, "full_bytes_equiv": 0,
            "dropped_deferred": 0, "deferred_max_age": 0,
            "reserved_slot_ticks": 0,
        }

    # --- liveness -----------------------------------------------------------
    def _liveness(self):
        t = self.tick if self.round_override is None else self.round_override
        if self.mask_fn is None:
            alive = np.ones(self.n_pods, bool)
            weights = np.full(self.n_pods, 1.0 / self.n_pods)
        else:
            alive, weights = self.mask_fn(t)
            alive = np.array(alive, bool, copy=True)
            weights = np.array(weights, float, copy=True)
        if self.chaos is not None:
            busy = [sum(s is not None for s in e.slots)
                    for e in self.engines]
            alive = self.chaos.overlay(self._chaos_state, self.tick,
                                       alive, busy)
        return alive, normalize_admission_weights(alive, weights)

    # --- request intake -----------------------------------------------------
    def submit(self, req: Request):
        """Queue a request; the router owns the plane-level PRNG seq, so
        the request's sampling stream is identical wherever it lands."""
        if len(req.prompt) >= self.engines[0].ecfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} "
                f"must be < max_len {self.engines[0].ecfg.max_len} (a "
                f"prompt that fills the whole cache row leaves no room "
                f"to decode)")
        if req.arch is not None and req.arch not in self._group_by_label:
            raise KeyError(
                f"request {req.uid}: no arch group {req.arch!r} on this "
                f"plane; groups: {sorted(self._group_by_label)}")
        if req._seq < 0:
            req._seq = self._next_seq
            self._next_seq += 1
        self.queue.append(req)

    def _group_for(self, req) -> int:
        """Arch group of a request (None = the default group: the one
        engines[0] belongs to)."""
        return 0 if req.arch is None else self._group_by_label[req.arch]

    def _home(self, req) -> int:
        """Key partition: a Knuth multiplicative hash of the request uid
        picks the session's home pod WITHIN its arch group."""
        pods = self._groups[self._group_for(req)]
        return pods[((int(req.uid) * 2654435761) & 0xFFFFFFFF) % len(pods)]

    def _free_cap(self, pod: int) -> int:
        return sum(s is None for s in self.engines[pod].slots)

    def _admit(self, alive, weights):
        """Partitioned admission: each request goes to its key's home pod
        while that pod is alive with unreserved capacity; otherwise it
        spills via smooth weighted round-robin over its arch group's live
        pods' free slots (each admission adds `weights` to every pod's
        credit and picks the group-live argmax — deterministic,
        bandwidth-proportional over time). Capacity reserved for deferred
        failovers is never admitted into. Head-of-line blocking is
        per-group: a full transformer group never stalls admissions into
        an idle recurrent group (or vice versa), and a group draining for
        a staged param swap holds only its own requests."""
        self._credits = np.where(alive, self._credits, 0.0)
        free = [self._free_cap(i) - int(self._reserved[i])
                for i in range(self.n_pods)]
        blocked = set(self._pending_params)   # groups draining for a swap
        admitted = []
        for qi, req in enumerate(self.queue):
            g = self._group_for(req)
            if g in blocked:
                continue
            home = self._home(req)
            if alive[home] and free[home] > 0:
                i = home
                self.stats["admitted_home"] += 1
            else:
                avail = [i for i in self._groups[g]
                         if alive[i] and free[i] > 0]
                if not avail:
                    blocked.add(g)   # keep the group's queue order
                    continue
                self._credits += weights
                i = max(avail,
                        key=lambda k: (self._credits[k], weights[k], -k))
                self._credits[i] -= 1.0
                self.stats["admitted_spill"] += 1
            admitted.append(qi)
            self.engines[i].submit(req)
            free[i] -= 1
            self.stats["admitted_per_pod"][i] += 1
            self._sessions[req._seq] = _Session(
                req, home, i, self.engines[i].params_version)
        for qi in reversed(admitted):
            self.queue.pop(qi)

    # --- session bookkeeping ------------------------------------------------
    @staticmethod
    def _kv_pos(req) -> int:
        """The slot's device kv pos, derived host-side: prefill sets
        pos = prompt_len (first token sampled without advancing), each
        decode sub-step writes one row. No device read needed — this is
        what keeps replication bookkeeping off the host-sync budget."""
        return len(req.prompt) + len(req.generated) - 1

    def _fresh(self, sess) -> bool:
        """A standby is promotable iff its KV cursor reached the source's
        pos AND the state row was synced after the source's last decode
        block — then promotion is a bit-exact continuation."""
        if sess.sb_pod is None or sess.slot is None:
            return False
        return (sess.cursor == self._kv_pos(sess.req)
                and sess.synced_len == len(sess.req.generated))

    def _bind_sessions(self):
        """Bind sessions to the slots the engines' prefill assigned."""
        for i, e in enumerate(self.engines):
            for s, req in enumerate(e.slots):
                if req is None:
                    continue
                sess = self._sessions.get(req._seq)
                if sess is not None and sess.pod == i:
                    sess.slot = s

    def _free_standby(self, sess):
        if sess.sb_row is not None:
            insort(self._sb_free[sess.sb_pod], sess.sb_row)
        sess.sb_pod = sess.sb_row = None
        sess.cursor = 0
        sess.synced_len = -1

    def _drop_session(self, sess):
        self._free_standby(sess)
        self._sessions.pop(sess.req._seq, None)

    def _collect_finished(self):
        for e in self.engines:
            if not e.finished:
                continue
            for r in e.finished:
                sess = self._sessions.pop(r._seq, None)
                if sess is not None and sess.sb_row is not None:
                    insort(self._sb_free[sess.sb_pod], sess.sb_row)
            self.finished.extend(e.finished)
            e.finished.clear()

    # --- failover (pointer flip > full drain > defer) -----------------------
    def _relocate(self, sess, dst: int, dslot: int, *, flip: bool,
                  failover: bool = True):
        """Host bookkeeping after a session moved to (dst, dslot).
        Failover moves count toward the outage contract stats
        (migrated_slots / pointer_flips / full_migrations); rebalance
        moves are accounted separately by the caller."""
        src_pod, src_slot = sess.pod, sess.slot
        self.engines[src_pod].slots[src_slot] = None
        if flip:
            # the dead pod is never touched: its stale row is wiped when
            # the pod rejoins (models the reboot clearing slot memory)
            self._pending_clear[src_pod].add(src_slot)
            self._free_standby(sess)     # the standby row was consumed
        sess.pod, sess.slot = dst, dslot
        if sess.sb_pod == dst:
            # a standby must live off the primary pod; rehome next sync
            self._free_standby(sess)
            self.stats["standby_rehomed"] += 1
        sess.defer_age = 0
        if failover:
            self.stats["migrated_slots"] += 1
            self.stats["pointer_flips" if flip else "full_migrations"] += 1

    def _failover(self, alive, weights):
        """Drain masked pods: pointer-flip every slot with a fresh
        resident standby, full-migrate the rest into any free capacity,
        defer (age + reserve) what cannot move yet."""
        self._reserved[:] = 0
        held = []
        for i in range(self.n_pods):
            if alive[i]:
                continue
            src = self.engines[i]
            if src.queue:            # un-prefilled admissions: just requeue
                for r in src.queue:
                    sess = self._sessions.pop(r._seq, None)
                    if sess is not None:
                        self._free_standby(sess)
                self.stats["requeued"] += len(src.queue)
                self.queue[:0] = src.queue
                src.queue = []
            held.extend(self._sessions[r._seq]
                        for r in src.slots if r is not None)
        if not held:
            return

        # 1) pointer flips claim standby-pod capacity FIRST, across all
        #    dead pods — a fresh standby is a standing reservation, and a
        #    full drain from some other dead pod must never steal the
        #    slot it points at
        flips = defaultdict(list)
        rest = []
        for sess in held:
            d = sess.sb_pod
            if (d is not None and alive[d] and self._fresh(sess)
                    and len(flips[d]) < self._free_cap(d)):
                flips[d].append(sess)
            else:
                rest.append(sess)
        for d in sorted(flips):
            group = flips[d]
            if not group:
                continue
            pairs = [(sess.sb_row, sess.req) for sess in group]
            for sess in group:
                assert sess.version == self.engines[d].params_version
            dslots = self.engines[d].promote_standby(pairs)
            for sess, ds in zip(group, dslots):
                self._relocate(sess, d, ds, flip=True)
            self.stats["migrations"] += 1

        # 2) full drain fallback into the remaining capacity, batched per
        #    source pod
        deferred = []
        by_src = defaultdict(list)
        for sess in rest:
            by_src[sess.pod].append(sess)
        for i in sorted(by_src):
            pending = by_src[i]
            while pending:
                # a drain may only land on a same-arch pod: the bundle is
                # raw decode-state rows in the source family's layout
                dests = [(j, self._free_cap(j))
                         for j in self._groups[self._group_of[i]]
                         if alive[j]]
                dests = [(j, f) for j, f in dests if f > 0]
                if not dests:
                    break
                j, f = max(dests, key=lambda t: (t[1], weights[t[0]],
                                                 -t[0]))
                take, pending = pending[:f], pending[f:]
                bundle = self.engines[i].export_slots(
                    [sess.slot for sess in take])
                dslots = self.engines[j].import_slots(bundle)
                for sess, ds in zip(take, dslots):
                    self._relocate(sess, j, ds, flip=False)
                self.stats["migrations"] += 1
            deferred.extend(pending)

        # 3) defer: age, reserve the standby pod's next free slot, police
        #    the starvation deadline
        starving = []
        for sess in deferred:
            sess.defer_age += 1
            self.stats["deferred_slot_migrations"] += 1
            self.stats["deferred_max_age"] = max(
                self.stats["deferred_max_age"], sess.defer_age)
            if (sess.sb_pod is not None and alive[sess.sb_pod]
                    and self._fresh(sess)):
                self._reserved[sess.sb_pod] += 1
            dl = self.grid.defer_deadline
            if dl is not None and sess.defer_age > dl:
                starving.append(sess)
        self.stats["reserved_slot_ticks"] += int(self._reserved.sum())
        for sess in starving:
            if not self.grid.shed_on_deadline:
                raise RuntimeError(
                    f"deferred slot starvation: request {sess.req.uid} "
                    f"has been frozen on masked pod {sess.pod} for "
                    f"{sess.defer_age} ticks (> defer_deadline="
                    f"{self.grid.defer_deadline}) with no capacity "
                    f"anywhere — raise capacity, shorten outages, or set "
                    f"GridConfig.shed_on_deadline to shed instead")
            self.engines[sess.pod].slots[sess.slot] = None
            self._pending_clear[sess.pod].add(sess.slot)
            self.dropped.append(sess.req)
            self._drop_session(sess)
            self.stats["dropped_deferred"] += 1

    def _on_rejoin(self, pod: int):
        """A masked pod came back: wipe rows whose generations were
        pointer-flipped away while it was dark (the reboot clears slot
        memory) so the revived engine can't decode stale sessions."""
        self.stats["rejoins"] += 1
        if self._pending_clear[pod]:
            self.engines[pod].clear_rows(sorted(self._pending_clear[pod]))
            self._pending_clear[pod].clear()

    # --- weight-aware background rebalance ----------------------------------
    def _quotas(self, live, weights, total):
        """Largest-remainder allocation of `total` active sessions over
        `live` pods proportional to admission weights, capped at each
        pod's slot count."""
        caps = {i: self.engines[i].ecfg.max_batch for i in live}
        w = np.array([weights[i] for i in live], float)
        w = w / w.sum() if w.sum() > 0 else np.full(len(live),
                                                    1.0 / len(live))
        ideal = w * total
        q = {i: min(int(f), caps[i]) for i, f in zip(live, np.floor(ideal))}
        rem = total - sum(q.values())
        frac = sorted(zip(live, ideal - np.floor(ideal)),
                      key=lambda t: (-t[1], t[0]))
        while rem > 0:
            moved = False
            for i, _ in frac:
                if rem > 0 and q[i] < caps[i]:
                    q[i] += 1
                    rem -= 1
                    moved = True
            if not moved:
                break
        return q

    def _rebalance(self, alive, weights):
        """Restore partition balance after a rejoin: move up to
        `_REBALANCE_PER_TICK` sessions from over- to under-quota pods
        (only while the pairwise gap is >= 2, so routine completions
        don't churn), preferring sessions homed on the destination and
        pointer-flipping when the session's standby already lives
        there. Partition affinity wins over load balance: a session
        sitting on its OWN home pod is never moved — only displaced
        (failed-over or spilled) sessions rebalance."""
        budget = _REBALANCE_PER_TICK
        moved = 0
        for g in range(len(self._groups)):
            moved += self._rebalance_group(g, alive, weights,
                                           budget - moved)
            if moved >= budget:
                break
        if moved:
            self.stats["rebalances"] += 1

    def _rebalance_group(self, g, alive, weights, budget) -> int:
        """Rebalance one arch group (moves never cross groups: the
        exported bundle is family-layout state rows)."""
        live = [i for i in self._groups[g] if alive[i]]
        if budget <= 0 or len(live) < 2:
            return 0
        active = {i: sum(s is not None for s in self.engines[i].slots)
                  for i in live}
        total = sum(active.values())
        if total == 0:
            return 0
        quota = self._quotas(live, weights, total)
        moved = 0
        while moved < budget:
            over = [i for i in live if active[i] - quota[i] >= 1]
            under = [j for j in live
                     if quota[j] - active[j] >= 1
                     and self._free_cap(j) - self._reserved[j] > 0]
            pairs = [(i, j) for i in over for j in under
                     if active[i] - active[j] >= 2]
            src = dst = sess = None
            for i, j in sorted(pairs, key=lambda t: (
                    active[t[0]] - quota[t[0]],
                    quota[t[1]] - active[t[1]],
                    weights[t[1]], -t[0], -t[1]), reverse=True):
                cands = sorted(
                    (self._sessions[r._seq]
                     for r in self.engines[i].slots if r is not None),
                    key=lambda s: (s.home != j, s.req._seq))
                cands = [s for s in cands if s.home != i]
                if cands:
                    src, dst, sess = i, j, cands[0]
                    break
            if sess is None:
                break
            if sess.sb_pod == dst and self._fresh(sess):
                src_slot = sess.slot
                [ds] = self.engines[dst].promote_standby(
                    [(sess.sb_row, sess.req)])
                self._relocate(sess, dst, ds, flip=True, failover=False)
                # the source pod is alive: wipe its stale row NOW
                self.engines[src].clear_rows([src_slot])
                self._pending_clear[src].discard(src_slot)
            else:
                bundle = self.engines[src].export_slots([sess.slot])
                [ds] = self.engines[dst].import_slots(bundle)
                self._relocate(sess, dst, ds, flip=False, failover=False)
            active[src] -= 1
            active[dst] += 1
            moved += 1
            self.stats["rebalanced_slots"] += 1
        return moved

    # --- incremental background replication ---------------------------------
    def _row_wire_bytes(self, pod: int):
        """(full, per_pos, carry) wire bytes of one slot row on `pod`'s
        engine, from the spec's axis declarations and the dtype its
        engine holds: computed once per arch group from shapes (no device
        work) and cached."""
        grp = self._group_of[pod]
        if grp not in self._wire_bytes_cache:
            self._wire_bytes_cache[grp] = self.engines[pod].spec.\
                row_wire_bytes(self.engines[pod].ecfg.max_len)
        return self._wire_bytes_cache[grp]

    def _replicate(self, alive):
        """Keep every live session's warm standby in sync: ship the KV
        rows written since the last sync plus the state row, one gather
        and one scatter per (source, standby) pod pair: no host syncs,
        nothing on the decode critical path. Sessions whose
        standby pod died (or collided with their primary) are rehomed
        and re-seeded."""
        if not self._replicating:
            return
        width = self.grid.repl_chunk or self.engines[0].ecfg.max_len
        jobs = defaultdict(list)
        for seq in sorted(self._sessions):
            sess = self._sessions[seq]
            if sess.slot is None or not alive[sess.pod]:
                continue             # unprefilled, or frozen on a dead pod
            if sess.sb_pod is not None and not alive[sess.sb_pod]:
                self._free_standby(sess)
                self.stats["standby_rehomed"] += 1
            if sess.sb_pod is None:
                # a standby must hold the same family's state layout, so
                # only same-arch pods have room for this session
                grp = self._group_of[sess.pod]
                has_room = [bool(self._sb_free[p])
                            and self._group_of[p] == grp
                            for p in range(self.n_pods)]
                weights = self._last_weights
                p = choose_standby_pod(sess.pod, alive, weights, has_room)
                if p is None:
                    continue         # unprotected until a pod frees up
                sess.sb_pod = p
                sess.sb_row = self._sb_free[p].pop(0)
                sess.cursor = 0
                sess.synced_len = -1
                self.stats["standby_seeded"] += 1
            pos = self._kv_pos(sess.req)
            if sess.cursor == pos and \
                    sess.synced_len == len(sess.req.generated):
                continue             # already fresh
            jobs[(sess.pod, sess.sb_pod)].append(sess)
        for src, dst in sorted(jobs):
            group = jobs[(src, dst)]
            bundle = self.engines[src].export_delta(
                [(sess.slot, sess.cursor) for sess in group], width)
            self.engines[dst].standby_apply(
                bundle, [(j, sess.sb_row) for j, sess in enumerate(group)])
            self.stats["replication_syncs"] += 1
            # carry groups ship the whole O(1) state every sync, so the
            # cursor jumps straight to pos (fresh after every sync); the
            # rows accounting charges 1 row either way so the KV savings
            # ratio is never inflated by carry traffic.  The BYTE
            # counters come from the spec's axis declarations
            # (row_wire_bytes), so a carry sync is charged its actual
            # O(1) leaf bytes — not pretended to be one full KV row —
            # and a windowed delta is charged carry + per_pos * rows.
            windowed = self.engines[src].spec.windowed
            full_b, per_pos_b, carry_b = self._row_wire_bytes(src)
            for sess in group:
                pos = self._kv_pos(sess.req)
                if windowed:
                    new_cursor = min(sess.cursor + width, pos)
                    self.stats["replicated_rows"] += new_cursor - sess.cursor
                    self.stats["full_rows_equiv"] += pos
                    self.stats["replicated_bytes"] += \
                        carry_b + per_pos_b * (new_cursor - sess.cursor)
                else:
                    new_cursor = pos
                    self.stats["replicated_rows"] += 1
                    self.stats["full_rows_equiv"] += 1
                    self.stats["replicated_bytes"] += full_b
                self.stats["full_bytes_equiv"] += full_b
                sess.cursor = new_cursor
                sess.synced_len = (len(sess.req.generated)
                                   if new_cursor == pos else -1)

    # --- group-wide param swap ---------------------------------------------
    @property
    def params_version(self) -> int:
        """The default arch group's lockstep version (the engine-
        compatible surface launchers poll; heterogeneous planes keep one
        version PER GROUP, readable off any of the group's engines)."""
        return self.engines[self._groups[0][0]].params_version

    def swap_params(self, new_params, arch: Optional[str] = None):
        """Stage `new_params` for one arch GROUP — the whole plane when
        homogeneous (the ParamPublisher sink). Admissions into the group
        are held; in-flight generations — including ones migrating off a
        masked pod — drain on the snapshot they were admitted under; once
        every replica OF THE GROUP is simultaneously empty the swap fans
        out to all of them in one step, keeping params_version in
        lockstep across the group (the invariant that makes any live
        same-arch replica a bit-exact failover target)."""
        if arch is None:
            g = 0
        elif arch not in self._group_by_label:
            raise KeyError(f"no arch group {arch!r} on this plane; "
                           f"groups: {sorted(self._group_by_label)}")
        else:
            g = self._group_by_label[arch]
        lead = self.engines[self._groups[g][0]]
        check_swap_compatible(lead._template, new_params)
        self._pending_params[g] = new_params
        self._maybe_apply_swap()
        return lead.params_version + (g in self._pending_params)

    def _maybe_apply_swap(self):
        for g in sorted(self._pending_params):
            pods = self._groups[g]
            if any(s is not None for i in pods
                   for s in self.engines[i].slots) \
                    or any(self.engines[i].queue for i in pods):
                continue
            new_params = self._pending_params.pop(g)
            for i in pods:
                self.engines[i].swap_params(new_params)  # idle: applies now
                assert self.engines[i]._pending_params is None
            self.stats["swaps"] += 1

    # --- stepping -----------------------------------------------------------
    def _settle(self):
        """Wait for every CUDA device the plane's engines run on: the two
        deliberate host waits of the failover-stall measurement (nothing
        to wait for on the CPU)."""
        for dev in sorted({str(e.device) for e in self.engines}):
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)  # repro-lint: allow[HS002] the two deliberate failover-stall waits: the stall clock starts with no queued work and ends after the moves' device work

    def step(self) -> int:
        """One grid tick: refresh the mask (chaos overlay included), wipe
        rejoined pods' stale rows, fail masked pods over (flip > drain >
        defer), rebalance, apply a staged plane swap if everything
        drained, admit into unreserved capacity, decode one block on
        every live pod with work, then replicate standby deltas. Returns
        active slots decoded."""
        alive, weights = self._liveness()
        self._last_weights = weights
        if self._last_alive is not None:
            trans = alive != self._last_alive
            self.stats["mask_transitions"] += int(trans.sum())
            for i in np.nonzero(trans & alive)[0]:
                self._on_rejoin(int(i))
        self._last_alive = alive.copy()
        self.stats["masked_pod_ticks"] += int((~alive).sum())

        stall_t = None
        if not alive.all() and any(
                s is not None for i in np.nonzero(~alive)[0]
                for s in self.engines[int(i)].slots):
            self._settle()       # queued device work off the stall clock
            stall_t = time.perf_counter()
        m0 = self.stats["migrated_slots"]
        self._failover(alive, weights)
        if stall_t is not None and self.stats["migrated_slots"] > m0:
            self._settle()       # the stall includes the moves' device work
            self.failover_stalls.append(time.perf_counter() - stall_t)
        self._rebalance(alive, weights)
        self._maybe_apply_swap()
        self._admit(alive, weights)   # holds groups with a staged swap
        n_active = 0
        for i, e in enumerate(self.engines):
            if alive[i] and (e.queue or any(s is not None
                                            for s in e.slots)):
                n_active += e.step()
        self._collect_finished()
        self._bind_sessions()
        self._replicate(alive)
        self._maybe_apply_swap()
        self.tick += 1
        return n_active

    def run(self, max_steps: int = 10_000):
        steps = 0
        while steps < max_steps and (
                self.queue
                or any(e.queue for e in self.engines)
                or any(s is not None for e in self.engines
                       for s in e.slots)):
            self.step()
            steps += 1
        return self.finished

    def trace_count(self) -> int:
        """The engines' compiled variants, summed."""
        return sum(e.trace_count() for e in self.engines)

    # --- engine-compatible surface -----------------------------------------
    @property
    def ecfg(self):
        return self.engines[0].ecfg

    @property
    def slots(self):
        """Flattened slot view (engine-compatible: launchers poll
        `any(s is not None for s in x.slots)`)."""
        return [s for e in self.engines for s in e.slots]

    def plane_stats(self) -> dict:
        """Router stats + summed engine stats (tokens, host_syncs, ...)
        + a live view of the grid (session count, standby coverage,
        current deferral ages)."""
        out = dict(self.stats)
        sessions = list(self._sessions.values())
        out["sessions_active"] = len(sessions)
        out["standby_covered"] = sum(s.sb_pod is not None for s in sessions)
        out["standby_fresh"] = sum(self._fresh(s) for s in sessions)
        ages = [s.defer_age for s in sessions if s.defer_age > 0]
        out["deferred_now"] = len(ages)
        out["deferred_max_age_now"] = max(ages, default=0)
        out["arch_occupancy"] = {
            self._group_label[g]: {
                "pods": len(pods),
                "slots": sum(self.engines[i].ecfg.max_batch for i in pods),
                "active": sum(s is not None for i in pods
                              for s in self.engines[i].slots),
                "state_kind": self.engines[pods[0]].spec.state_kind,
            }
            for g, pods in enumerate(self._groups)}
        agg = {}
        for e in self.engines:
            for k, v in e.stats.items():
                agg[k] = agg.get(k, 0) + v
        out["engines"] = agg
        return out


def check_forced_outage_contract(plane: ConstellationRouter, done,
                                 n_requests: int, *,
                                 expect_pointer_flip: bool = False,
                                 expect_rebalance: bool = False):
    """The fault-injection smoke contract, shared by the serve and
    coserve launchers (and CI): injected outages must complete every
    request (zero drops) and must actually exercise the failover path
    (>= 1 slot moved). With a replicating grid the caller can further
    demand that >= 1 failover was a pointer flip, and — for schedules
    with repair windows — that the rebalancer actually ran on rejoin.
    Raises SystemExit on violation."""
    if len(done) != n_requests:
        raise SystemExit(f"dropped requests under forced outage: "
                         f"{len(done)}/{n_requests} finished")
    if plane.stats["dropped_deferred"]:
        raise SystemExit(f"shed {plane.stats['dropped_deferred']} deferred "
                         f"slots under forced outage")
    if plane.stats["migrated_slots"] < 1:
        raise SystemExit("forced outage caused no failovers — the drain "
                         "path did not run")
    if expect_pointer_flip and plane.stats["pointer_flips"] < 1:
        raise SystemExit("no pointer-flip failover happened — every "
                         "failover fell back to a full drain")
    if expect_rebalance and plane.stats["rebalanced_slots"] < 1:
        raise SystemExit("no rebalance after rejoin — the plane stayed "
                         "skewed")


def liveness_mask_fn(link_model):
    """Adapt a `ConstellationLinkModel` to the router's mask_fn contract:
    tick -> (alive, bandwidth-proportional weights) via `serving_mask`."""
    def fn(t):
        alive, weights, _ = link_model.serving_mask(int(t))
        return alive, weights
    return fn
