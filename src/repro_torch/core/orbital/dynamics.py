"""Orbital dynamics right-hand sides: point-mass gravity + J2, optional
drag.

State convention: y = cat([r, v]) with r, v in ECI coordinates [m, m/s].
Plain tensor functions in the dtype and on the device of their inputs,
differentiable by autograd (the formation controller backpropagates
through them).  Every operation is elementwise, in the reference's order:
a norm is sqrt((x0 x0 + x1 x1) + x2 x2), as `jnp.linalg.norm` sums, and an
integer power the products `lax.integer_pow` takes (x^5 = x (x^2)^2), and
a scalar over a tensor one division.  No
reduction kernel or library power decides a rounding, so a state's
acceleration has the same bits on the CPU and the card, alone or in any
batch.
"""
from __future__ import annotations

import torch

from .constants import J2_EARTH, MU_EARTH, R_EARTH


def _dot3(a, b, keepdim: bool = False):
    """Sum over the last axis (3) of a * b, in order."""
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out[..., None] if keepdim else out


def _norm(x, keepdim: bool = False):
    return torch.sqrt(_dot3(x, x, keepdim))


def _rdiv(c: float, x):
    """c / x as one division (torch's `c / x` multiplies by 1 / x)."""
    return x.new_tensor(c) / x


def _pow3(x):
    return x * (x * x)


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def accel_point_mass(r, mu: float = MU_EARTH):
    """Newtonian two-body acceleration. r: (..., 3)."""
    rn = _norm(r, keepdim=True)
    return -mu * r / _pow3(rn)


def accel_j2(r, mu: float = MU_EARTH, j2: float = J2_EARTH,
             r_eq: float = R_EARTH):
    """J2 (oblateness) perturbation acceleration in ECI. r: (..., 3).

    a_xy = -(3/2) J2 (mu/r^2)(Re/r)^2 (x/r) (1 - 5 z^2/r^2)
    a_z  = -(3/2) J2 (mu/r^2)(Re/r)^2 (z/r) (3 - 5 z^2/r^2)
    """
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    rn = _norm(r)
    k = _rdiv(-1.5 * j2 * mu * r_eq**2, _pow5(rn))
    z2_r2 = (z / rn) * (z / rn)
    ax = k * x * (1.0 - 5.0 * z2_r2)
    ay = k * y * (1.0 - 5.0 * z2_r2)
    az = k * z * (3.0 - 5.0 * z2_r2)
    return torch.stack([ax, ay, az], dim=-1)


def accel_drag(r, v, bc: float = 0.0, rho0: float = 2.0e-13,
               h0: float = 650e3, scale_h: float = 70e3):
    """Simple exponential-atmosphere drag, a = -1/2 rho v |v| / BC.

    bc is the inverse ballistic coefficient [m^2/kg * Cd]; bc=0 disables
    drag."""
    if bc == 0.0:
        return torch.zeros_like(v)
    alt = _norm(r, keepdim=True) - R_EARTH
    rho = rho0 * torch.exp(-(alt - h0) / scale_h)
    return -0.5 * rho * bc * _norm(v, keepdim=True) * v


def make_rhs(j2: bool = True, mu: float = MU_EARTH, drag_bc: float = 0.0):
    """Return f(t, y) -> dy/dt for y = (..., 6) = [r, v]."""

    def rhs(t, y):
        r, v = y[..., :3], y[..., 3:]
        a = accel_point_mass(r, mu)
        if j2:
            a = a + accel_j2(r, mu)
        if drag_bc:
            a = a + accel_drag(r, v, drag_bc)
        return torch.cat([v, a], dim=-1)

    return rhs


def specific_energy(y, mu: float = MU_EARTH):
    """Keplerian specific orbital energy (conserved without J2/drag)."""
    r, v = y[..., :3], y[..., 3:]
    return 0.5 * _dot3(v, v) - _rdiv(mu, _norm(r))


def mean_motion(a: float, mu: float = MU_EARTH) -> float:
    return (mu / a**3) ** 0.5
