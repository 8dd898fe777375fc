"""Differentiable explicit Runge-Kutta integrators on tensors.

The paper's Methods (§4.1) integrate with SciPy's 8th-order DOP853; the
supplementary material proposes backpropagating through the ODE
integration for formation control.  As the reference
(`repro.core.orbital.integrators`) does, this module integrates with
fixed steps of:

- `rk4_step`        : classic 4th order
- `dopri5_step`     : Dormand-Prince 5(4), the reference's tableau
- `integrate`       : the final state after n steps
- `integrate_dense` : the strided trajectory

A Python loop takes the place of `lax.scan`; autograd differentiates
through it.  Each step is a few dozen small tensor ops, so on the card a
trajectory is bound by kernel launches, not by arithmetic.
"""
from __future__ import annotations

from typing import Callable

import torch

# Dormand-Prince 5(4) Butcher tableau (RK45, "dopri5").
_DP_C = (0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0)
_DP_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
     -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
     11.0 / 84.0),
)
_DP_B5 = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
          11.0 / 84.0, 0.0)
_DP_B4 = (5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
          -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0)


def rk4_step(f: Callable, t, y, dt):
    k1 = f(t, y)
    k2 = f(t + 0.5 * dt, y + 0.5 * dt * k1)
    k3 = f(t + 0.5 * dt, y + 0.5 * dt * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _dopri5_stages(f: Callable, t, y, dt) -> list:
    ks = []
    for i in range(7):
        yi = y
        for aij, kj in zip(_DP_A[i], ks):
            yi = yi + dt * aij * kj
        ks.append(f(t + _DP_C[i] * dt, yi))
    return ks


def dopri5_step(f: Callable, t, y, dt):
    """One 5th-order Dormand-Prince step (no error estimate)."""
    out = y
    for bi, ki in zip(_DP_B5, _dopri5_stages(f, t, y, dt)):
        out = out + dt * bi * ki
    return out


def dopri5_step_err(f: Callable, t, y, dt):
    """dopri5 step plus embedded 4th-order error estimate."""
    out, err = y, torch.zeros_like(y)
    for b5, b4, ki in zip(_DP_B5, _DP_B4, _dopri5_stages(f, t, y, dt)):
        out = out + dt * b5 * ki
        err = err + dt * (b5 - b4) * ki
    return out, err


_STEPPERS = {"rk4": rk4_step, "dopri5": dopri5_step}


def integrate(f: Callable, y0, t0: float, dt: float, n_steps: int,
              method: str = "dopri5"):
    """Integrate to t0 + n_steps*dt, returning only the final state."""
    step = _STEPPERS[method]
    t, y = t0, y0
    for _ in range(n_steps):
        y = step(f, t, y, dt)
        t = t + dt
    return y


def integrate_dense(f: Callable, y0, t0: float, dt: float, n_steps: int,
                    method: str = "dopri5", stride: int = 1):
    """Integrate and return (times, trajectory) sampled every `stride`
    steps: trajectory[0] is y0; shape (n_steps//stride + 1, *y0.shape)."""
    step = _STEPPERS[method]
    t, y = t0, y0
    ys = [y0]
    for _ in range(n_steps // stride):
        for _ in range(stride):
            y = step(f, t, y, dt)
            t = t + dt
        ys.append(y)
    n = n_steps // stride + 1
    ts = t0 + dt * stride * torch.arange(n, dtype=y0.dtype, device=y0.device)
    return ts, torch.stack(ys)
