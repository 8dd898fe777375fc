"""Hill-Clohessy-Wiltshire (HCW) relative motion and the paper's lattice
design, in numpy float32 (and float64 for the J2 orbit).

Hill frame convention (circular reference orbit, mean motion n):
  x : radial (+zenith),  y : along-track (+velocity),  z : cross-track

Zero-secular-drift, concentric family used by the paper's planar 81-sat
cluster (§2.2): each satellite is parameterized by (alpha, beta) with

  x(t) = kappa * (alpha sin nt + beta cos nt)
  y(t) = 2     * (alpha cos nt - beta sin nt)

i.e. a 2:kappa axis-ratio ellipse.  Positions at any t are a linear map
of (alpha, beta), so the square lattice stays a (sheared) lattice and the
cluster shape repeats twice per orbit; direct neighbours oscillate
between s and 2s.

Precision: the reference computes these in float32 (jax with x64 off),
and the liveness model's k-nearest-neighbour graph breaks exact distance
ties by the last bit of each position (ROADMAP C5).  So this module
computes in float32 too, with the same operation order: scalar factors
in float64 and then rounded, as jax rounds weak-typed Python floats.
sin and cos of the float32 phase are taken in float64 and rounded once
(correctly rounded; XLA's float32 sin/cos may differ by an ulp).

`lattice_alpha_beta` and `hcw_state` also take dtype=np.float64: the J2
orbit and the formation controller run in binary64, as the reference does
under jax_enable_x64, where these are plain float64 expressions.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def _sincos(arg) -> tuple:
    """float32 sin and cos of a float32 phase, correctly rounded."""
    a = np.asarray(arg, np.float32).astype(np.float64)
    return np.sin(a).astype(np.float32), np.cos(a).astype(np.float32)


def _phase(rate: float, t) -> np.ndarray:
    """rate * t in float64, rounded to float32 (jax's canonicalisation)."""
    return np.asarray(rate * np.asarray(t, np.float64)).astype(np.float32)


def lattice_alpha_beta(n_side: int = 9, spacing: float = 100.0,
                       dtype=np.float32):
    """Square (alpha, beta) lattice centered at the origin. Returns (N,2)."""
    half = (n_side - 1) / 2.0
    idx = np.arange(n_side, dtype=dtype) - dtype(half)
    a, b = np.meshgrid(idx * dtype(spacing), idx * dtype(spacing),
                       indexing="ij")
    return np.stack([a.ravel(), b.ravel()], axis=-1)


def hcw_state(alpha_beta, n: float, t, kappa: float = 1.0,
              dtype=np.float32):
    """Analytic Hill-frame state for the concentric zero-drift family.

    alpha_beta: (..., 2). Returns (..., 6) = [x, y, z, vx, vy, vz] in
    dtype (float32 or float64).

    kappa != 1 selects the J2-modified bounded family (axis ratio
    2:kappa): in-plane frequency omega = n*kappa*sqrt(2/(1+kappa^2));
    kappa=1 recovers exact Keplerian HCW.
    """
    if dtype == np.float64:
        return _hcw_state64(np.asarray(alpha_beta, np.float64), n, t, kappa)
    alpha_beta = np.asarray(alpha_beta, np.float32)
    al, be = alpha_beta[..., 0], alpha_beta[..., 1]
    omega = n * kappa * (2.0 / (1.0 + kappa * kappa)) ** 0.5
    s, c = _sincos(_phase(omega, t))
    x = f32(kappa) * (al * s + be * c)
    y = f32(2.0) * (al * c - be * s)
    vx = f32(kappa * omega) * (al * c - be * s)
    vy = f32(-2.0 * omega) * (al * s + be * c)
    z = np.zeros_like(x)
    return np.stack([x, y, z, vx, vy, z], axis=-1)


def _hcw_state64(alpha_beta, n: float, t, kappa: float):
    """hcw_state in float64, the reference's expressions in its order."""
    al, be = alpha_beta[..., 0], alpha_beta[..., 1]
    omega = n * kappa * (2.0 / (1.0 + kappa * kappa)) ** 0.5
    s, c = np.sin(omega * t), np.cos(omega * t)
    x = kappa * (al * s + be * c)
    y = 2.0 * (al * c - be * s)
    vx = kappa * omega * (al * c - be * s)
    vy = -2.0 * omega * (al * s + be * c)
    z = np.zeros_like(x)
    return np.stack([x, y, z, vx, vy, z], axis=-1)


def hcw_propagate(state0, n: float, t):
    """General closed-form HCW propagation of an arbitrary Hill state.

    state0: (..., 6). Returns the state at time t (float32)."""
    state0 = np.asarray(state0, np.float32)
    x0, y0, z0 = state0[..., 0], state0[..., 1], state0[..., 2]
    vx0, vy0, vz0 = state0[..., 3], state0[..., 4], state0[..., 5]
    s, c = _sincos(_phase(n, t))
    nt, three_nt = _phase(n, t), _phase(3.0 * n, t)
    fn = f32(n)
    x = (f32(4.0) - f32(3.0) * c) * x0 + (s / fn) * vx0 \
        + f32(2.0 / n) * (f32(1.0) - c) * vy0
    y = f32(6.0) * (s - nt) * x0 + y0 - f32(2.0 / n) * (f32(1.0) - c) * vx0 \
        + (f32(4.0) * s - three_nt) / fn * vy0
    z = c * z0 + (s / fn) * vz0
    vx = f32(3.0 * n) * s * x0 + c * vx0 + f32(2.0) * s * vy0
    vy = f32(-6.0 * n) * (f32(1.0) - c) * x0 - f32(2.0) * s * vx0 \
        + (f32(4.0) * c - f32(3.0)) * vy0
    vz = f32(-n) * s * z0 + c * vz0
    return np.stack([x, y, z, vx, vy, vz], axis=-1)


def neighbor_pairs(n_side: int = 9):
    """(i, j) index pairs for direct (4-) and diagonal (8-) neighbors of the
    lattice center satellite."""
    center = (n_side // 2) * n_side + n_side // 2
    cr, cc = n_side // 2, n_side // 2
    direct, diag = [], []
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        direct.append((center, (cr + dr) * n_side + (cc + dc)))
    for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        diag.append((center, (cr + dr) * n_side + (cc + dc)))
    return center, direct, diag
