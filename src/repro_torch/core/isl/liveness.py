"""Constellation-in-the-loop liveness: orbital/ISL state -> pod masks for
BOTH planes — the DiLoCo training mask (`mask_at`) and its serving twin
(`serving_mask`, which also yields bandwidth-proportional admission
weights for a request router).

This is the bridge from `repro_torch.core` (the physics half) to
`repro_torch.train` / `repro_torch.serving` (the workload half). The
paper's failure model for orbital training is set by the constellation
itself, not by the accelerators:

  - The cluster "breathes" twice per orbit (§2.2, Fig. 3): direct-neighbor
    distances oscillate between s and 2s, and the spatially-multiplexed FSO
    bandwidth scales ~1/d (§2.1, Fig. 1), so every pod's aggregate ISL
    bandwidth oscillates with orbit phase. A pod whose outer-sync transfer
    (`outer_wire_bytes` over its cross-pod aggregate bandwidth) cannot meet
    the round deadline is a *straggler* and is masked from that round's
    outer average (bounded-staleness DiLoCo semantics, §3).
  - Restart-class radiation events — chip SEFI and HBM UECC (§2.3,
    measured rates in `repro_torch.core.radiation.seu`) — knock
    satellites out mid-round; the affected pod is masked until its
    reboot/rejoin repair window ends.

Everything here is a PURE function of (design, config, round index): the
orbit is precomputed once, and the outage draws fold the PRNG on the round
id, so a rollback replay of round r regenerates bit-identical masks. That
determinism is what lets the DiLoCo supervisor replay rounds after a
rollback and verify the replay bit-exactly.

The default orbit is the analytic HCW lattice in float32, as the
reference computes it: the k-nearest-neighbour graph breaks exact
distance ties by the last bit of each position, so a float64 orbit would
pick other neighbours (ROADMAP C5).  The J2 numerical orbit
(`integrate=True`, `simulate_cluster`) runs in float64 on the model's
`device`: there J2 separates the lattice's equal distances by far more
than a binary64 ulp, so the neighbours are set by the physics and equal
the reference's at float64; in float32 (the reference's precision under
its launcher) an ulp at 7e6 m is 0.5 m and rounding picks them (ROADMAP
C9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..orbital.cluster import ClusterDesign, simulate_cluster
from ..orbital.hcw import hcw_state
from ..radiation.seu import (HBM_UECC_DOSE_PER_EVENT_RAD,
                             SEFI_DOSE_PER_EVENT_RAD, RadiationEnvironment)
from .topology import ISLNetwork


def normalize_admission_weights(alive, weights):
    """(alive bool (n,), raw weights (n,)) -> admission distribution:
    dead pods weigh 0, live weights sum to 1 (uniform-over-alive when the
    raw live weights sum to 0), all-dead -> all zeros. Shared by
    `ConstellationLinkModel.serving_mask` and the serving router's
    forced-outage re-mask so the two can't drift."""
    alive = np.asarray(alive, bool)
    weights = np.where(alive, np.asarray(weights, float), 0.0)
    total = weights.sum()
    if total > 0:
        return weights / total
    if alive.any():
        return alive / alive.sum()
    return weights


def choose_standby_pod(primary: int, alive, weights, has_room):
    """Pick the warm-standby pod for a session homed on `primary`: the
    nearest ring neighbor (pods partition the lattice into contiguous
    satellite ranges, so ring distance tracks physical/ISL adjacency)
    among ALIVE pods with standby room, breaking distance ties toward
    the higher-bandwidth pod (then the lower index). Returns None when no
    live pod can host a replica. Shared by the serving grid's replication
    placement so standby locality follows the same liveness/bandwidth
    signal as admission."""
    alive = np.asarray(alive, bool)
    weights = np.asarray(weights, float)
    n = alive.size
    best = None
    for p in range(n):
        if p == primary or not alive[p] or not has_room[p]:
            continue
        d = min((p - primary) % n, (primary - p) % n)
        key = (d, -weights[p], p)
        if best is None or key < best[0]:
            best = (key, p)
    return None if best is None else best[1]


@dataclass(frozen=True)
class LivenessConfig:
    """Round -> mask model parameters.

    round_time_s=None picks period/16 — a smoke-scale cadence that sweeps
    the full orbit (and both shape-cycles) in a few dozen rounds; real
    deployments pass the measured H * step_time round duration.
    round_deadline_s=None derives the straggler deadline from the orbit
    itself: the `deadline_percentile` of per-(phase, pod) outer-sync times,
    so pods straggle exactly in the expanded (low-bandwidth) phases.
    """
    n_pods: int = 2
    outer_wire_bytes: int = 4_000_000
    round_time_s: float | None = None
    round_deadline_s: float | None = None
    deadline_percentile: float = 75.0
    chips_per_satellite: int = 256
    samples_per_orbit: int = 64
    k_neighbors: int = 8
    seed: int = 0
    outage_rate_multiplier: float = 1.0
    # dominated by HBM UECC (~3.4/chip/yr): an ECC-uncorrectable host
    # restart is minutes, not a full satellite reboot — at ~10k chips/pod
    # this sets the pod-level downtime fraction (rate * repair_time)
    repair_time_s: float = 120.0
    integrate: bool = False               # True: J2 numerical orbit (slower)


class ConstellationLinkModel:
    """Precomputes one orbit of cluster geometry and answers, per DiLoCo
    round index, which pods are alive and at what aggregate ISL bandwidth.

    Pods partition the lattice into contiguous satellite index ranges; a
    pod's bandwidth is the summed capacity of neighbor-graph links crossing
    its boundary (the links its outer-sync delta must traverse). With one
    pod there is no cross-pod hop and the full neighbor aggregate is used.
    `device` is where the J2 orbit integrates (`cfg.integrate`), the card
    unless the caller names the CPU; the rest is host numpy.
    """

    def __init__(self, design: ClusterDesign | None = None,
                 cfg: LivenessConfig | None = None,
                 env: RadiationEnvironment | None = None,
                 network: ISLNetwork | None = None, device="cuda"):
        self.design = design or ClusterDesign()
        self.device = device
        self.cfg = cfg or LivenessConfig()
        self.env = env or RadiationEnvironment()
        self.network = network or ISLNetwork()
        if not 1 <= self.cfg.n_pods <= self.design.n_sats:
            raise ValueError(
                f"n_pods={self.cfg.n_pods} outside [1, {self.design.n_sats}]")

        self.period = self.design.period
        self.round_time_s = (self.cfg.round_time_s
                             if self.cfg.round_time_s is not None
                             else self.period / 16.0)
        self.repair_rounds = max(
            1, math.ceil(self.cfg.repair_time_s / self.round_time_s))

        self._pod_of = np.empty(self.design.n_sats, dtype=int)
        pods = np.array_split(np.arange(self.design.n_sats), self.cfg.n_pods)
        for p, sats in enumerate(pods):
            self._pod_of[sats] = p
        chips = np.array([len(s) for s in pods]) * self.cfg.chips_per_satellite
        restart_rate = (  # restart-class events / chip / second (§2.3)
            self.env.rate_per_chip_second(SEFI_DOSE_PER_EVENT_RAD)
            + self.env.rate_per_chip_second(HBM_UECC_DOSE_PER_EVENT_RAD))
        self._lam_pod = (chips * restart_rate * self.round_time_s *
                         self.cfg.outage_rate_multiplier)

        self._pod_bw = self._precompute_orbit()          # (S, n_pods) bit/s
        wire_bits = 8.0 * self.cfg.outer_wire_bytes
        with np.errstate(divide="ignore"):
            self._sync_s = np.where(self._pod_bw > 0,
                                    wire_bits / self._pod_bw, np.inf)
        self.round_deadline_s = (
            self.cfg.round_deadline_s
            if self.cfg.round_deadline_s is not None
            else float(np.percentile(self._sync_s,
                                     self.cfg.deadline_percentile)))

    # -- orbit precompute ----------------------------------------------------
    def _positions_over_orbit(self) -> np.ndarray:
        """(S, N, 3) Hill positions at `samples_per_orbit` phases."""
        S = self.cfg.samples_per_orbit
        if self.cfg.integrate:
            _, hill, _ = simulate_cluster(self.design, n_orbits=1.0,
                                          samples_per_orbit=S,
                                          dtype=torch.float64,
                                          device=self.device)
            return hill[:S, :, :3].cpu().numpy()
        ts = np.linspace(0.0, self.period, S, endpoint=False)
        ab = self.design.alpha_beta()
        return np.stack([
            np.asarray(hcw_state(ab, self.design.n, t,
                                 self.design.kappa)[..., :3])
            for t in ts])

    def _precompute_orbit(self) -> np.ndarray:
        positions = self._positions_over_orbit()
        n_pods = self.cfg.n_pods
        bw = np.zeros((positions.shape[0], n_pods))
        for s, pos in enumerate(positions):
            edges, caps = self.network.neighbor_graph(pos,
                                                      self.cfg.k_neighbors)
            pi, pj = self._pod_of[edges[:, 0]], self._pod_of[edges[:, 1]]
            if n_pods == 1:
                bw[s, 0] = caps.sum()
                continue
            cross = pi != pj
            np.add.at(bw[s], pi[cross], caps[cross])
            np.add.at(bw[s], pj[cross], caps[cross])
        return bw

    # -- round-indexed queries (all pure in (cfg, round_idx)) ----------------
    def phase_index(self, round_idx: int) -> int:
        frac = (round_idx * self.round_time_s % self.period) / self.period
        return int(frac * self.cfg.samples_per_orbit) \
            % self.cfg.samples_per_orbit

    def pod_bandwidth_bps(self, round_idx: int) -> np.ndarray:
        return self._pod_bw[self.phase_index(round_idx)]

    def sync_time_s(self, round_idx: int) -> np.ndarray:
        return self._sync_s[self.phase_index(round_idx)]

    def outage_events(self, round_idx: int) -> np.ndarray:
        """Restart-class events striking each pod AT round `round_idx` —
        Poisson at the §2.3 SEFI+UECC rate, PRNG folded on the round id so
        rollback replay redraws the identical outage schedule."""
        rng = np.random.default_rng((self.cfg.seed, round_idx))
        return rng.poisson(self._lam_pod)

    def outage_mask(self, round_idx: int) -> np.ndarray:
        """(n_pods,) bool: pod is down at `round_idx` if a restart-class
        event struck it within the trailing repair window."""
        dead = np.zeros(self.cfg.n_pods, dtype=bool)
        for r in range(max(0, round_idx - self.repair_rounds + 1),
                       round_idx + 1):
            dead |= self.outage_events(r) > 0
        return dead

    def mask_at(self, round_idx: int):
        """(mask (n_pods,) float32, info dict) for one DiLoCo round.

        mask[p] = 1.0 iff pod p is neither an ISL straggler (outer sync
        misses the round deadline at this orbit phase) nor inside a
        radiation-outage repair window. Bit-deterministic in
        (design, cfg, round_idx).
        """
        sync_s = self.sync_time_s(round_idx)
        straggler = sync_s > self.round_deadline_s
        outage = self.outage_mask(round_idx)
        mask = (~(straggler | outage)).astype(np.float32)
        info = {"phase": self.phase_index(round_idx),
                "pod_bandwidth_bps": self.pod_bandwidth_bps(round_idx),
                "sync_time_s": sync_s,
                "straggler": straggler,
                "outage": outage}
        return mask, info

    def serving_mask(self, round_idx: int):
        """(alive (n_pods,) bool, weights (n_pods,) f32, info) — the
        SERVING twin of `mask_at`, for the request router.

        Same straggler + outage machinery, same round index: a pod masked
        for training round r is masked for serving at r, deterministically
        (alive == mask_at(r)[0] > 0; asserted in tests). `weights` is each
        live pod's share of cross-pod aggregate ISL bandwidth at the
        round's orbit phase (dead pods weigh 0; all-dead rounds return
        all-zero weights) — the admission policy's bias toward
        well-connected pods, so traffic follows the cluster's breathing
        exactly like the training deadline does.
        """
        mask, info = self.mask_at(round_idx)
        alive = mask > 0
        weights = normalize_admission_weights(
            alive, info["pod_bandwidth_bps"])
        return alive, weights.astype(np.float32), info

    def mask_series(self, n_rounds: int):
        """(masks (n_rounds, n_pods) f32, stats dict) — the orbit's outage/
        straggler profile as the benchmark and launcher report it."""
        masks = np.empty((n_rounds, self.cfg.n_pods), np.float32)
        stragglers = outages = 0
        for r in range(n_rounds):
            masks[r], info = self.mask_at(r)
            stragglers += int(info["straggler"].sum())
            outages += int(info["outage"].sum())
        transitions = int((masks[1:] != masks[:-1]).sum())
        stats = {
            "rounds": n_rounds,
            "masked_pod_fraction": float(1.0 - masks.mean()),
            "straggler_pod_rounds": stragglers,
            "outage_pod_rounds": outages,
            "mask_transitions": transitions,
            "round_time_s": self.round_time_s,
            "round_deadline_s": self.round_deadline_s,
        }
        return masks, stats
