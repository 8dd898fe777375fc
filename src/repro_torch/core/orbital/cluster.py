"""The paper's illustrative 81-satellite, 1 km-radius planar cluster (§2.2).

Design: 9x9 square lattice in the HCW (alpha, beta) parameter plane with
100 m spacing, all satellites in the orbital plane of a circular,
dawn-dusk sun-synchronous reference orbit at 650 km altitude.  The cluster
is integrated under point-mass gravity + J2 (the dominant differential
perturbation at this altitude) and analysed relative to the central
reference satellite S0, reproducing Figures 2 and 3 and the §2.2
J2-drift-compensation result.

Precision: the J2 orbit defaults to float64, the paper's binary64 (the
reference's tests run it under jax_enable_x64).  At 7e6 m a float32 ulp
is 0.5 m, so a float32 orbit's lattice distances are set by rounding
(ROADMAP C5, C9).  The analytic HCW lattice stays in float32
(`hcw.py`), as the liveness model's HCW orbit reads it.

Device: every function here that makes tensors takes a required
`device` keyword; the card ("cuda") and the CPU give the same orbit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import constants as C
from .dynamics import _norm, _rdiv, make_rhs, mean_motion
from .frames import _rotate, eci_to_hill, hill_basis, hill_to_eci
from .hcw import hcw_state, lattice_alpha_beta, neighbor_pairs
from .integrators import integrate_dense

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def sun_sync_inclination(a: float, dtype=torch.float32) -> float:
    """Inclination [rad] making the node precess once per year at radius
    a.  float32 rounds as the reference's arccos does with x64 off (the
    HCW liveness path); float64 is the plain binary64 arccos."""
    n = mean_motion(a)
    cos_i = -C.OMEGA_SUN_SYNC / (1.5 * C.J2_EARTH * n * (C.R_EARTH / a) ** 2)
    if dtype == torch.float64:
        return float(np.arccos(cos_i))
    return float(np.float32(np.arccos(np.float64(np.float32(cos_i)))))


@dataclass(frozen=True)
class ClusterDesign:
    n_side: int = C.CLUSTER_N_SIDE
    spacing: float = C.CLUSTER_SPACING
    altitude: float = C.CLUSTER_ALTITUDE
    kappa: float = 1.0                 # radial axis-ratio factor (J2 compensation)
    sun_synchronous: bool = True
    # Beyond-paper: rescale each satellite's speed so its osculating
    # semi-major axis exactly equals the reference's, which removes the
    # second-order (A^2/a) period mismatch of the linearized HCW init.
    energy_matched: bool = False

    @property
    def a(self) -> float:
        return C.R_EARTH + self.altitude

    @property
    def n(self) -> float:
        return mean_motion(self.a)

    @property
    def period(self) -> float:
        return float(2.0 * math.pi / self.n)

    @property
    def n_sats(self) -> int:
        return self.n_side ** 2

    def inclination(self, dtype=torch.float32) -> float:
        return (sun_sync_inclination(self.a, dtype)
                if self.sun_synchronous else 0.0)

    def alpha_beta(self, dtype=torch.float32) -> np.ndarray:
        return lattice_alpha_beta(self.n_side, self.spacing, _NP[dtype])

    def reference_state(self, dtype=torch.float64, *, device):
        """Circular reference orbit ECI state at the ascending node."""
        a, inc = self.a, self.inclination(dtype)
        v = (C.MU_EARTH / a) ** 0.5
        r0 = torch.tensor([a, 0.0, 0.0], dtype=dtype, device=device)
        v0 = v * torch.tensor([0.0, math.cos(inc), math.sin(inc)],
                              dtype=dtype, device=device)
        return torch.cat([r0, v0])

    def initial_states(self, dtype=torch.float64, *, device):
        """(N, 6) absolute ECI states of all satellites at t=0."""
        ref = self.reference_state(dtype, device=device)
        rel = torch.from_numpy(hcw_state(self.alpha_beta(dtype), self.n, 0.0,
                                         self.kappa, _NP[dtype])).to(device)
        y = hill_to_eci(ref, rel)
        if self.energy_matched:
            r = _norm(y[..., :3], keepdim=True)
            v = y[..., 3:]
            target = torch.sqrt(_rdiv(2.0 * C.MU_EARTH, r)
                                - C.MU_EARTH / self.a)
            v = v * target / _norm(v, keepdim=True)
            y = torch.cat([y[..., :3], v], dim=-1)
        return y


def simulate_clusters(designs, n_orbits: float = 1.0, dt: float = 5.0,
                      samples_per_orbit: int = 120, j2: bool = True,
                      dtype=torch.float64, *, device):
    """`simulate_cluster` for several designs of one period and size (the
    same altitude and lattice, e.g. other kappas) in one integration:
    (ts, hill (T, D, N, 6), rel_inertial (T, D, N, 3)).  Every operation
    is per satellite, so design d's slice is bitwise its own run, at the
    launches of one."""
    period, n_sats = designs[0].period, designs[0].n_sats
    if any((d.period, d.n_sats) != (period, n_sats) for d in designs):
        raise ValueError("simulate_clusters needs one period and lattice "
                         "size")
    rhs = make_rhs(j2=j2)
    y0 = torch.stack([d.initial_states(dtype, device=device)
                      for d in designs])
    # snap dt so that samples exactly tile [0, n_orbits * period]
    span = n_orbits * period
    n_samples = max(1, int(round(n_orbits * samples_per_orbit)))
    stride = max(1, int(np.ceil(span / (dt * n_samples))))
    n_steps = n_samples * stride
    dt = span / n_steps
    ts, traj = integrate_dense(rhs, y0, 0.0, dt, n_steps, stride=stride)

    ref_traj = traj[:, :, n_sats // 2]  # S0: lattice centre, (T, D, 6)
    hill = eci_to_hill(ref_traj, traj)
    # Fig. 2 frame: fixed (non-rotating) basis = Hill basis at t=0
    rot0 = hill_basis(ref_traj[0, :, :3], ref_traj[0, :, 3:])
    rel_inertial = _rotate(traj[..., :3] - ref_traj[..., None, :3],
                           rot0[:, None])
    return ts, hill, rel_inertial


def simulate_cluster(design: ClusterDesign, n_orbits: float = 1.0,
                     dt: float = 5.0, samples_per_orbit: int = 120,
                     j2: bool = True, dtype=torch.float64, *, device):
    """Integrate the cluster; return (ts, hill_states, rel_inertial).

    hill_states: (T, N, 6) Hill-frame states relative to the integrated S0.
    rel_inertial: (T, N, 3) relative positions projected on the *t=0* Hill
    basis (the paper's Fig. 2 "non-rotating coordinate system").
    """
    ts, hill, rel = simulate_clusters([design], n_orbits, dt,
                                      samples_per_orbit, j2, dtype,
                                      device=device)
    return ts, hill[:, 0], rel[:, 0]


def neighbor_distances(hill, n_side: int = 9):
    """Distances from S0 to its direct and diagonal lattice neighbours.

    hill: (T, N, 6). Returns (direct (T,4), diagonal (T,4)): Fig. 3."""
    _, direct, diag = neighbor_pairs(n_side)
    pos = hill[..., :3]

    def dists(pairs):
        return torch.stack(
            [_norm(pos[:, j] - pos[:, i]) for i, j in pairs], dim=-1)

    return dists(direct), dists(diag)


def secular_drift_rates(design: ClusterDesign, n_orbits: float = 10.0,
                        dt: float = 5.0, samples_per_orbit: int = 96,
                        j2: bool = True, dtype=torch.float64, *, device):
    """Per-satellite secular along-track drift velocity [m/s] (numpy).

    The along-track Hill coordinate is detrended of its periodic component
    by a one-orbit moving average, then fit with a least-squares line; the
    slope is the secular drift velocity (cluster-disintegration rate)."""
    ts, hill, _ = simulate_cluster(design, n_orbits=n_orbits, dt=dt,
                                   samples_per_orbit=samples_per_orbit,
                                   j2=j2, dtype=dtype, device=device)
    return _drift(ts, hill[..., 1], samples_per_orbit)


def _drift(ts, along, samples_per_orbit: int):
    """Secular drift slopes (N,) of along-track positions (T, N)."""
    y = along.cpu().numpy()
    t = ts.cpu().numpy()
    kern = np.ones(samples_per_orbit) / samples_per_orbit
    ybar = np.apply_along_axis(
        lambda v: np.convolve(v, kern, mode="valid"), 0, y)
    tbar = np.convolve(t, kern, mode="valid")
    basis = np.stack([np.ones_like(tbar), tbar - tbar[0]], axis=1)
    coef, *_ = np.linalg.lstsq(basis, ybar, rcond=None)
    return coef[1]  # (N,) m/s


def j2_drift_rate(design: ClusterDesign, n_orbits: float = 10.0,
                  dt: float = 5.0, dtype=torch.float64, *,
                  device) -> float:
    """Worst-case annualized station-keeping delta-v, m/s/year per km of
    maximal distance from the reference orbit (the paper's §2.2 metric).

    The secular drift velocity v_d per satellite must be re-cancelled
    every orbit (J2 re-induces it), so annual delta-v ~= v_d * orbits per
    year, normalized by each satellite's maximal distance (2A, km)."""
    return _j2_drift_rates([design], n_orbits, dt, dtype, device)[0]


def _j2_drift_rates(designs, n_orbits: float, dt: float, dtype,
                    device) -> list:
    """`j2_drift_rate` of several designs of one period and size, from one
    `simulate_clusters` integration (each design's rate is bitwise its
    own run's)."""
    spo = 96
    ts, hill, _ = simulate_clusters(designs, n_orbits, dt, spo,
                                    dtype=dtype, device=device)
    out = []
    for i, design in enumerate(designs):
        rates = _drift(ts, hill[:, i, :, 1], spo)
        ab = design.alpha_beta(dtype)
        dist_km = np.maximum(np.linalg.norm(ab, axis=-1) * 2.0,
                             design.spacing) / 1e3
        orbits_per_year = C.SECONDS_PER_YEAR / design.period
        out.append(float(np.max(np.abs(rates) / dist_km) * orbits_per_year))
    return out


def tune_axis_ratio(base: ClusterDesign, kappas=None, n_orbits: float = 10.0,
                    dt: float = 5.0, dtype=torch.float64, *, device):
    """Numerically tune the in-plane axis ratio to minimize J2 drift (the
    paper's 'simplistic numerical calculation', §2.2), all kappas in one
    integration (`simulate_clusters`).  The optimal kappa
    depends on the reference-orbit convention (osculating vs J2-mean
    circular speed, an O(J2) = 0.1% effect); the paper reports 2:1.0037
    for its convention.  Returns (best_kappa, {kappa: dv_rate})."""
    if kappas is None:
        kappas = np.linspace(0.998, 1.002, 9)
    designs = [ClusterDesign(n_side=base.n_side, spacing=base.spacing,
                             altitude=base.altitude, kappa=float(k),
                             sun_synchronous=base.sun_synchronous)
               for k in kappas]
    rates = _j2_drift_rates(designs, n_orbits, dt, dtype, device)
    results = {float(k): r for k, r in zip(kappas, rates)}
    best = min(results, key=results.get)
    return best, results
