"""Hill (LVLH) <-> ECI frame conversions for formation initialization and
analysis, batched: a leading batch of reference states broadcasts as
`jax.vmap` maps the reference's functions.  Cross products (as
`jnp.cross` spells them) and 3 x 3 rotations are written out elementwise,
so a batched call equals its rows' single calls, and the card the CPU,
bit for bit."""
from __future__ import annotations

import torch

from .dynamics import _dot3, _norm


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _rotate(x, rot):
    """x (..., 3) @ rot (..., 3, 3): each output the ordered sum of three
    products."""
    return (x[..., 0, None] * rot[..., 0, :] + x[..., 1, None] * rot[..., 1, :]
            + x[..., 2, None] * rot[..., 2, :])


def hill_basis(r_ref, v_ref):
    """Rotation matrices (..., 3, 3) whose columns are the Hill axes
    expressed in ECI, for reference positions and velocities (..., 3).

    x: radial, z: orbit normal, y: z cross x (approximately along-track).
    """
    xh = r_ref / _norm(r_ref, keepdim=True)
    h = _cross(r_ref, v_ref)
    zh = h / _norm(h, keepdim=True)
    yh = _cross(zh, xh)
    return torch.stack([xh, yh, zh], dim=-1)


def hill_to_eci(ref_state, rel_state):
    """Convert Hill-frame relative states to absolute ECI states.

    ref_state: (6,) reference ECI state; rel_state: (..., 6) Hill states.
    Accounts for the rotating frame: v_eci = v_ref + R v_rel + omega x
    (R r_rel).
    """
    r0, v0 = ref_state[:3], ref_state[3:]
    rot = hill_basis(r0, v0)
    h = _cross(r0, v0)
    omega = h / _dot3(r0, r0)   # instantaneous orbital angular velocity
    dr = _rotate(rel_state[..., :3], rot.T)
    dv = _rotate(rel_state[..., 3:], rot.T)
    r = r0 + dr
    v = v0 + dv + _cross(omega, dr)
    return torch.cat([r, v], dim=-1)


def eci_to_hill(ref_state, abs_state):
    """Convert absolute ECI states to Hill-frame states relative to ref.

    ref_state: (..., 6) reference states; abs_state: (..., N, 6) states of
    N satellites per reference state (the leading dims match)."""
    r0, v0 = ref_state[..., None, :3], ref_state[..., None, 3:]
    rot = hill_basis(ref_state[..., :3], ref_state[..., 3:])[..., None, :, :]
    h = _cross(r0, v0)
    omega = h / _dot3(r0, r0, keepdim=True)
    dr = abs_state[..., :3] - r0
    dv = abs_state[..., 3:] - v0 - _cross(omega, dr)
    return torch.cat([_rotate(dr, rot), _rotate(dv, rot)], dim=-1)
