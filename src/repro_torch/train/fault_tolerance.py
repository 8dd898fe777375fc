"""Fault-tolerant training supervisor: the reference's SDC screens,
rollback and livelock guard around the port's train step.

Failure model:
  - SDC (silent bit-flips): not self-announcing.  Detected by (a)
    non-finite / loss-spike screens, (b) gradient-norm screens against a
    running median, (c) an optional duplicate-step check (recompute the
    loss and compare bit-exactly) every `verify_every` steps.
  - Restart-class events: the supervisor restores the newest verifiable
    checkpoint replica and replays; the deterministic data pipeline
    (train/data.py) makes replay exact.

Detection triggers a rollback to the last checkpoint rather than a skip:
a flipped parameter bit would otherwise persist.

Two supervisor modes:
  - `run()`: the per-step host loop, one host sync per step (screens on
    the host).
  - `run_fused()`: the screens run on the device (`screen_update`) over a
    device-resident ring buffer inside a fused K-step block
    (train/loop.py:make_fused_steps); the host drains one (K, metrics)
    block per K steps.

Livelock guard (both modes): a genuine spike re-triggers the same screen
after every bit-deterministic replay.  After `max_rollbacks_per_step`
consecutive rollbacks at the same step the spike thresholds widen by
`widen_factor` per further detection; a persistent non-finite loss raises.

The fault injector is any object with `SDCInjector`'s
`maybe_inject(params, forced_events=...) -> (params, n)`
(`repro_torch.core.radiation.injection`); it runs in the per-step loop.

`DiLoCoSupervisor` runs DiLoCo rounds (train/diloco.py) with pod masks
from the constellation, per-pod rollback on the device, whole-round
rollback with bitwise replay verification, replicated checkpoints and a
publisher for co-resident serving.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from . import checkpoint as ckpt
from .data import pod_step_grid
from .tree import tree_map


@dataclass
class FTConfig:
    """Fault-tolerance supervisor knobs (the reference's, field for field).

    Fields:
      checkpoint_dirs: replica directories snapshots fan out to; restore
        picks the newest replica that passes its checksum (no default:
        the caller says where checkpoints go).
      checkpoint_every: steps between checkpoints.
      keep: retained checkpoints per replica dir (older ones pruned).
      gnorm_window: running-median window (steps) for the spike screens;
        also the device ring-buffer length in fused mode.
      gnorm_threshold: gradient-norm spike multiplier over the median.
      loss_threshold: loss spike multiplier over the median.
      verify_every: duplicate-step check cadence (0 = off; host loop only).
      min_screen: clean samples required before the spike screens arm.
      drain_every: fused mode: steps per host drain (K).
      max_rollbacks_per_step: consecutive same-point rollbacks tolerated
        before the livelock guard widens thresholds (or raises, for
        persistent non-finite).
      widen_factor: spike-threshold multiplier per detection past the cap.
    """
    checkpoint_dirs: tuple
    checkpoint_every: int = 50
    keep: int = 3
    gnorm_window: int = 32
    gnorm_threshold: float = 10.0
    loss_threshold: float = 3.0
    verify_every: int = 0
    min_screen: int = 8
    drain_every: int = 8
    max_rollbacks_per_step: int = 3
    widen_factor: float = 2.0


# --------------------------------------------------------------------------
# device-side screens: a ring buffer + running-median spike checks, all
# tensor ops (no host sync), used by train/loop.py:make_fused_steps
# --------------------------------------------------------------------------
def screen_init(window: int = 32, device="cuda"):
    """Metrics ring buffer; lives on the device beside the train state."""
    return {"loss": torch.zeros(window, dtype=torch.float32, device=device),
            "gnorm": torch.zeros(window, dtype=torch.float32, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _masked_median(ring, n):
    """Median of the first n entries (entries are written densely before
    the ring wraps, so validity is exactly `index < n`)."""
    w = ring.shape[0]
    valid = torch.arange(w, device=ring.device) < n
    vals = torch.sort(torch.where(valid, ring, torch.inf)).values
    n = torch.clamp(n, min=1).long()
    mid = torch.stack([(n - 1) // 2, n // 2])
    return 0.5 * vals.gather(0, mid).sum()


def screen_update(screen, loss, gnorm, loss_thr, gnorm_thr,
                  min_count: int = 8):
    """One on-device screen step.  Returns (screen, flags).

    Mirrors the host `_suspicious` semantics: non-finite always flags;
    spike screens arm once `min_count` clean samples are in the window;
    flagged samples are not appended (they would poison the median).
    """
    w = screen["loss"].shape[0]
    loss = loss.float()
    gnorm = gnorm.float()
    nonfinite = ~(torch.isfinite(loss) & torch.isfinite(gnorm))
    n = torch.clamp(screen["count"], max=w)
    active = n >= min_count
    med_l = _masked_median(screen["loss"], n)
    med_g = _masked_median(screen["gnorm"], n)
    loss_spike = active & ~nonfinite & \
        (loss > loss_thr * torch.clamp(med_l, min=1e-12))
    gnorm_spike = active & ~nonfinite & \
        (gnorm > gnorm_thr * torch.clamp(med_g, min=1e-12))
    suspect = nonfinite | loss_spike | gnorm_spike

    keep = ~suspect
    write = keep & (torch.arange(w, device=loss.device)
                    == screen["count"] % w)
    new = {"loss": torch.where(write, loss, screen["loss"]),
           "gnorm": torch.where(write, gnorm, screen["gnorm"]),
           "count": screen["count"] + keep.to(torch.int32)}
    flags = {"nonfinite": nonfinite, "loss_spike": loss_spike,
             "gnorm_spike": gnorm_spike, "suspect": suspect}
    return new, flags


class DetectionPolicy:
    """The rollback livelock guard: cap consecutive detections at the same
    point, widen the spike thresholds per further detection past the cap,
    raise on persistent non-finite."""

    def __init__(self, ft: FTConfig, stats: dict | None = None):
        self.loss_threshold = ft.loss_threshold
        self.gnorm_threshold = ft.gnorm_threshold
        self._cap = ft.max_rollbacks_per_step
        self._widen = ft.widen_factor
        self.stats = stats if stats is not None else \
            {"sdc_detected": 0, "threshold_widenings": 0}
        self._last = None
        self._consec = 0

    def on_detection(self, at, reason: str):
        """`at` labels the detection point; consecutive detections at the
        same label count toward the cap."""
        self.stats["sdc_detected"] += 1
        self._consec = self._consec + 1 if at == self._last else 1
        self._last = at
        if self._consec > self._cap:
            if reason == "non-finite":
                raise RuntimeError(
                    f"persistent non-finite loss/gnorm at {at} after "
                    f"{self._consec - 1} rollbacks: divergence, not "
                    "transient SDC")
            self.loss_threshold *= self._widen
            self.gnorm_threshold *= self._widen
            self.stats["threshold_widenings"] += 1


_BLOCK_KEYS = ("loss", "grad_norm", "lr_scale", "nonfinite", "loss_spike",
               "gnorm_spike", "suspect")


class FaultTolerantTrainer:
    """Host-side supervisor around a train step.

    `fused_steps` (optional): a (state, screen, batches, thresholds) ->
    (state, screen, block) function from train/loop.py:make_fused_steps,
    enabling `run_fused`.  The trainer keeps the step counter on the host
    as well, so its loops read the device only to drain metrics and to
    snapshot checkpoints; `stats["host_syncs"]` counts those reads.
    """

    def __init__(self, train_step, state, data, ft: FTConfig,
                 injector=None, fused_steps=None):
        self.train_step = train_step
        self.state = state
        self.data = data
        self.ft = ft
        self.injector = injector
        self.fused_steps = fused_steps
        self.gnorms = collections.deque(maxlen=ft.gnorm_window)
        self.losses = collections.deque(maxlen=ft.gnorm_window)
        self.stats = {"rollbacks": 0, "sdc_detected": 0, "sdc_injected": 0,
                      "checkpoints": 0, "verify_failures": 0,
                      "threshold_widenings": 0, "drains": 0,
                      "host_syncs": 0}
        self.policy = DetectionPolicy(ft, self.stats)
        self._ckpt_threads = []
        self.step = int(state["step"])
        self._save_checkpoint(self.step)

    # -- detection ----------------------------------------------------------
    def _suspicious(self, loss: float, gnorm: float) -> str | None:
        if not np.isfinite(loss) or not np.isfinite(gnorm):
            return "non-finite"
        if len(self.gnorms) >= self.ft.min_screen:
            med_g = float(np.median(self.gnorms))
            med_l = float(np.median(self.losses))
            if gnorm > self.policy.gnorm_threshold * max(med_g, 1e-12):
                return "grad-norm spike"
            if loss > self.policy.loss_threshold * max(med_l, 1e-12):
                return "loss spike"
        return None

    def _verify(self, batch) -> bool:
        """Duplicate-step check: recompute and compare losses bit-exactly
        (catches SDC in compute, which the statistical screens miss)."""
        _, m1 = self.train_step(self.state, batch)
        _, m2 = self.train_step(self.state, batch)
        self.stats["host_syncs"] += 1
        same = bool(torch.equal(m1["loss"], m2["loss"]))
        if not same:
            self.stats["verify_failures"] += 1
        return same

    # -- checkpoint/rollback ------------------------------------------------
    def _save_checkpoint(self, step: int):
        """Replicated snapshot: the device-to-host copy happens here, the
        npz/fsync work on background threads.  Joining the previous
        cadence's threads first bounds the pileup to one in-flight save."""
        for t in self._ckpt_threads:
            t.join()
        self._ckpt_threads = ckpt.save_replicated_async(
            self.state, self.ft.checkpoint_dirs, step, self.ft.keep)
        self.stats["checkpoints"] += 1
        self.stats["host_syncs"] += 1

    def join_checkpoints(self):
        """Wait for in-flight background checkpoint writes."""
        for t in self._ckpt_threads:
            t.join()
        self._ckpt_threads = []

    def _rollback(self):
        # the newest snapshot may still be serialising: join first so
        # restore_latest sees it
        self.join_checkpoints()
        self.step, self.state = ckpt.restore_latest(self.state,
                                                    self.ft.checkpoint_dirs)
        self.stats["rollbacks"] += 1
        self.gnorms.clear()
        self.losses.clear()
        return self.step

    def _maybe_checkpoint(self, old_step: int, new_step: int):
        ce = self.ft.checkpoint_every
        if new_step // ce > old_step // ce:
            self._save_checkpoint(new_step)

    # -- main loops ---------------------------------------------------------
    def run(self, n_steps: int, forced_sdc_at: dict | None = None):
        """Run to n_steps with detection/rollback.  forced_sdc_at: {step:
        n_bits} pins deterministic fault injection for tests."""
        history = []
        forced_sdc_at = dict(forced_sdc_at or {})
        while self.step < n_steps:
            step = self.step
            batch = self.data.batch_at(step)

            if self.injector is not None:
                # consume the forced event: replayed steps after a
                # rollback must not re-inject, mirroring a transient SEE
                forced = forced_sdc_at.pop(step, None)
                params, n = self.injector.maybe_inject(
                    self.state["params"], forced_events=forced)
                if n:
                    self.stats["sdc_injected"] += n
                    self.state = {**self.state, "params": params}

            new_state, metrics = self.train_step(self.state, batch)
            loss, gnorm = torch.stack([metrics["loss"].float(),  # repro-lint: allow[HS001] the per-step path's one drain per step (loss and grad norm in one transfer), counted in stats["host_syncs"]
                                       metrics["grad_norm"].float()]
                                      ).tolist()
            self.stats["host_syncs"] += 1

            reason = self._suspicious(loss, gnorm)
            if reason is None and self.ft.verify_every and \
                    step % self.ft.verify_every == 0:
                if not self._verify(batch):
                    reason = "duplicate-step mismatch"
            if reason is not None:
                self.policy.on_detection(f"step {step}", reason)
                self._rollback()
                continue

            self.state = new_state
            self.step = step + 1
            self.gnorms.append(gnorm)
            self.losses.append(loss)
            history.append({"step": step, "loss": loss, "gnorm": gnorm})
            self._maybe_checkpoint(step, step + 1)
        self.join_checkpoints()
        return history

    def run_fused(self, n_steps: int):
        """Device-screened mode: K steps per fused call, screens on the
        device, one (K, metrics) host drain per block.  Requires
        `fused_steps`."""
        if self.fused_steps is None:
            raise ValueError("construct with fused_steps="
                             "make_fused_steps(...)")
        if self.injector is not None or self.ft.verify_every:
            # both are host-driven per-step mechanisms; silently skipping
            # them would report a spuriously clean fault-injection run
            raise ValueError(
                "run_fused does not support the host-driven SDCInjector or "
                "verify_every duplicate-step checks; use run() for those, "
                "or drop them from the config")
        k = self.ft.drain_every
        device = self.state["step"].device
        history = []
        screen = screen_init(self.ft.gnorm_window, device)
        while self.step < n_steps:
            step = self.step
            if n_steps - step < k:
                # ragged tail: finish on the per-step path
                history.extend(self.run(n_steps))
                break
            batches = self.data.batch_block(np.arange(step, step + k))
            thresholds = torch.tensor(
                [self.policy.loss_threshold, self.policy.gnorm_threshold],
                dtype=torch.float32, device=device)
            new_state, new_screen, block = self.fused_steps(
                self.state, screen, batches, thresholds)
            # the one host sync per K steps
            drained = torch.stack([block[n].float() for n in _BLOCK_KEYS]  # repro-lint: allow[HS001] the fused path's one drain per K-step block, counted in stats["host_syncs"]
                                  ).cpu().numpy()
            block = dict(zip(_BLOCK_KEYS, drained))
            self.stats["drains"] += 1
            self.stats["host_syncs"] += 1

            suspects = block["suspect"] > 0
            if suspects.any():
                i = int(np.argmax(suspects))
                if block["nonfinite"][i] > 0:
                    reason = "non-finite"
                elif block["gnorm_spike"][i] > 0:
                    reason = "grad-norm spike"
                else:
                    reason = "loss spike"
                self.policy.on_detection(f"step {step + i}", reason)
                self._rollback()
                screen = screen_init(self.ft.gnorm_window, device)
                continue

            self.state = new_state
            self.step = step + k
            screen = new_screen
            for i in range(k):
                history.append({"step": step + i,
                                "loss": float(block["loss"][i]),
                                "gnorm": float(block["grad_norm"][i])})
            # mirror the drained block into the host deques so the spike
            # screens stay armed when a ragged tail falls back to run()
            self.losses.extend(float(x) for x in block["loss"])
            self.gnorms.extend(float(x) for x in block["grad_norm"])
            self._maybe_checkpoint(step, step + k)
        self.join_checkpoints()
        return history


def drain(metrics: dict) -> dict:
    """Device metrics -> numpy, in one device-to-host transfer: every
    tensor goes through float32 (exact for the f32 losses, bool flags and
    0/1 masks the rounds return) and comes back at its own dtype."""
    names = list(metrics)
    flat = torch.cat([metrics[n].float().reshape(-1) for n in names])
    flat = flat.cpu().numpy()  # repro-lint: allow[HS001] the supervisor's single per-round metrics drain
    out, at = {}, 0
    for n in names:
        t = metrics[n]
        part = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
        out[n] = part.astype(bool) if t.dtype == torch.bool else part
    return out


class DiLoCoSupervisor:
    """Constellation-in-the-loop DiLoCo supervisor.  Per round it:
      1. derives the pod liveness mask from the orbital/ISL/radiation
         state (a `repro_torch.core.isl.ConstellationLinkModel`; None =
         all pods always live) — a pure function of the round id, so a
         rollback replay regenerates it bitwise;
      2. runs one round (`make_diloco_round(..., supervise=True)`) and
         drains its (n_pods, H) metrics block — the one host sync;
      3. relies on the round's per-pod rollback on the device: a flagged
         pod was already excluded from the outer average, re-broadcast
         and had its EF residual, moments and screen reset — the host
         only does the bookkeeping (DetectionPolicy's livelock handling);
      4. escalates to a whole-round rollback only when the outer state is
         suspect (`outer_ok` False) or a rollback is forced: restores the
         host snapshot, truncates the history back to the snapshot round
         and verifies the replayed rounds' losses bitwise against the
         truncated tail;
      5. snapshots on the checkpoint cadence: one device-to-host copy,
         then replicated background writes (`save_replicated_async`);
      6. with a `publisher` (train/publish.py:ParamPublisher), stages the
         outer params after every successful round and releases them to
         the serving sink once the snapshot watermark (plus the
         publisher's holdback) has passed them.
    """

    def __init__(self, round_fn, d_state, dcfg, ft: FTConfig,
                 liveness=None, grid_fn=None, publisher=None):
        self.round_fn = round_fn
        self.d_state = d_state
        self.dcfg = dcfg
        self.ft = ft
        self.liveness = liveness
        self.publisher = publisher
        self.device = d_state["step"].device
        self.grid_fn = grid_fn or (lambda r: torch.as_tensor(
            pod_step_grid(r, dcfg.n_pods, dcfg.inner_steps),
            device=self.device))
        self.stats = {
            "drains": 0, "rollbacks": 0, "pod_rollbacks": 0,
            "masked_pod_rounds": 0, "straggler_pod_rounds": 0,
            "outage_pod_rounds": 0, "mask_transitions": 0,
            "checkpoints": 0, "replay_verified_rounds": 0,
            "replay_mismatches": 0, "sdc_detected": 0,
            "threshold_widenings": 0}
        self.policy = DetectionPolicy(ft, self.stats)
        self.history = []            # one dict per completed round
        self.round = 0
        self._outer_consec = 0       # consecutive outer-suspect rollbacks
        self._last_outer_round = None
        self._replayed_until = 0     # rounds below this are replays
        self._ckpt_threads = []
        self._snap_round = 0
        self._snap = ckpt.host_copy(d_state)
        self._save_replicated()

    @property
    def mean_losses(self):
        return [h["loss"] for h in self.history]

    @property
    def verified_round(self):
        """The publication watermark: rounds at or below the newest host
        snapshot can never be rolled back again."""
        return self._snap_round

    def _to_device(self, host_state):
        return tree_map(lambda t: t.to(self.device), host_state)

    def _save_replicated(self):
        for t in self._ckpt_threads:   # bound thread pileup to one cadence
            t.join()
        self._ckpt_threads = ckpt.save_replicated_async(
            self._snap, self.ft.checkpoint_dirs, int(self._snap["step"]),
            self.ft.keep, copy=False)
        self.stats["checkpoints"] += len(self.ft.checkpoint_dirs)

    def join_checkpoints(self):
        """Wait for in-flight background checkpoint writes."""
        for t in self._ckpt_threads:
            t.join()
        self._ckpt_threads = []

    def _mask_for(self, r: int):
        if self.liveness is None:
            return np.ones(self.dcfg.n_pods, np.float32), None
        return self.liveness.mask_at(r)

    def _whole_round_rollback(self, expected: dict):
        """Restore the snapshot; stash the truncated history tail so the
        deterministic replay can be verified against it."""
        self.stats["rollbacks"] += 1
        self._replayed_until = max(self._replayed_until, self.round)
        for h in self.history[self._snap_round:]:
            expected[h["round"]] = (h["loss_bytes"], h["thresholds"])
        del self.history[self._snap_round:]
        self.d_state = self._to_device(self._snap)
        self.round = self._snap_round
        if self.publisher is not None:
            self.publisher.on_rollback(self.round)

    def restore_from_checkpoint(self):
        """Restart-class (SEFI/UECC) recovery: the newest verifiable
        replica wins, the round counter follows the restored step."""
        self.join_checkpoints()
        step, state = ckpt.restore_latest(self._snap,
                                          self.ft.checkpoint_dirs)
        self._snap = state
        self._snap_round = int(step) // self.dcfg.inner_steps
        self.d_state = self._to_device(state)
        self.round = self._snap_round
        del self.history[self._snap_round:]
        if self.publisher is not None:
            self.publisher.on_rollback(self.round)
        return self._snap_round

    def run(self, n_rounds: int, forced_rollback_at=None, on_round=None):
        """Run to `n_rounds`, deriving masks per round.
        forced_rollback_at: round ids at which a whole-round rollback is
        forced once.  on_round(self) is called after every drain —
        success or rollback — which is where a co-resident serving engine
        pumps its queue (launch/coserve.py)."""
        forced = set(forced_rollback_at or ())
        expected = {}                 # round -> stashed (loss_bytes, thr)
        n_pods = self.dcfg.n_pods
        snap_every = max(1, self.ft.checkpoint_every
                         // self.dcfg.inner_steps)
        while self.round < n_rounds:
            r = self.round
            mask_np, info = self._mask_for(r)
            thr = (self.policy.loss_threshold, self.policy.gnorm_threshold)
            self.d_state, metrics = self.round_fn(
                self.d_state, self.grid_fn(r),
                torch.as_tensor(mask_np, dtype=torch.float32,
                                device=self.device),
                torch.tensor(thr, dtype=torch.float32, device=self.device))
            metrics = drain(metrics)            # the one sync per round
            self.stats["drains"] += 1

            outer_ok = bool(metrics.get("outer_ok", True))
            if not outer_ok or r in forced:
                forced.discard(r)
                if not outer_ok:
                    # counted here, not only by DetectionPolicy: per-pod
                    # detections interleaved between successive outer
                    # detections during replay reset its counter
                    self._outer_consec = (self._outer_consec + 1
                                          if r == self._last_outer_round
                                          else 1)
                    self._last_outer_round = r
                    if self._outer_consec > self.ft.max_rollbacks_per_step:
                        raise RuntimeError(
                            f"persistent outer-state corruption at round "
                            f"{r} after {self._outer_consec - 1} "
                            "rollbacks: replay is deterministic, so this "
                            "is divergence, not transient SDC")
                    self.policy.on_detection(f"round {r}", "non-finite")
                self._whole_round_rollback(expected)
                if on_round is not None:
                    on_round(self)
                continue

            pod_bad = metrics.get("pod_bad", np.zeros(n_pods, bool))
            nonfinite = metrics["nonfinite"]
            if r >= self._replayed_until:
                # replays of counted rounds trip the same screens again:
                # count (and advance the livelock policy on) fresh
                # evidence only
                for p in np.nonzero(pod_bad)[0]:
                    self.stats["pod_rollbacks"] += 1
                    self.policy.on_detection(
                        f"pod {int(p)}",
                        "non-finite" if nonfinite[p].any() else "spike")

            alive = metrics.get("pod_alive", mask_np)
            loss = metrics["loss"]
            # flagged pods' rows were excluded from the outer state, so
            # they are excluded from the recorded mean too
            good = ~pod_bad
            loss_mean = (float(loss[good].mean()) if good.any()
                         else float("nan"))
            stash = expected.pop(r, None)
            if stash is not None and stash[1] == thr:
                self.stats["replay_verified_rounds"] += 1
                if stash[0] != loss.tobytes():
                    self.stats["replay_mismatches"] += 1
            self.history.append({
                "round": r, "loss": loss_mean,
                "alive": np.asarray(alive, np.float32),
                "straggler": (int(info["straggler"].sum())
                              if info is not None else 0),
                "outage": (int(info["outage"].sum())
                           if info is not None else 0),
                "loss_bytes": loss.tobytes(), "thresholds": thr})
            self.round = r + 1
            if self.publisher is not None:
                # a device-to-device copy, staged before the next round
                self.publisher.on_round_complete(self.round, self.d_state)
            if self.round % snap_every == 0:
                self._snap = ckpt.host_copy(self.d_state)
                self._snap_round = self.round
                self._save_replicated()
            if self.publisher is not None:
                self.publisher.advance(self.round, self._snap_round)
            if on_round is not None:
                on_round(self)
        self.join_checkpoints()
        self._finalize_mask_stats()
        return self.history

    def _finalize_mask_stats(self):
        """Mask accounting from the (rollback-truncated) history: replayed
        rounds must not double-count, so these are derived, not summed."""
        n_pods = self.dcfg.n_pods
        alive = np.array([h["alive"] for h in self.history]) \
            if self.history else np.zeros((0, n_pods), np.float32)
        self.stats["masked_pod_rounds"] = int(
            (n_pods - alive.sum(axis=1)).sum())
        self.stats["straggler_pod_rounds"] = sum(h["straggler"]
                                                 for h in self.history)
        self.stats["outage_pod_rounds"] = sum(h["outage"]
                                              for h in self.history)
        self.stats["mask_transitions"] = int(
            (alive[1:] != alive[:-1]).sum()) if len(alive) > 1 else 0
