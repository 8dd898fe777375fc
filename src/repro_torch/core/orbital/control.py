"""ML-based formation-flight control by backpropagation through ODE
integration (the paper's supplementary-material proposal).

An objective whose evaluation *is* a numerical ODE integration of the
whole constellation's motion, a parameterised controller (a small shared
MLP mapping each satellite's Hill-frame tracking error to a bounded
thrust command), and reverse-mode AD through the integrator (autograd
through a Python loop of dopri5 steps) for the gradients of accumulated
formation error + delta-v cost with respect to the controller's
parameters.

The controller is zero-order-hold: thrust is constant over each control
interval, with several integrator substeps inside.  Everything runs in
the dtype and on the device of the initial states (float64 by default,
as the reference's tests run it); on the card each substep is a few
dozen small kernels, so a rollout is bound by launches.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cluster import ClusterDesign
from .dynamics import accel_j2, accel_point_mass
from .frames import _rotate, eci_to_hill, hill_basis
from .hcw import hcw_state
from .integrators import dopri5_step


def init_policy(generator: torch.Generator, hidden: int = 32,
                dtype=torch.float64, *, device):
    """Tiny MLP: 6 (scaled Hill error) -> hidden -> 3 (thrust direction,
    bounded).  Draws from `generator` (not jax's normal sampler: carry the
    reference's draws with `policy_from_jax`)."""
    scale = 0.1

    def normal(*shape):
        return scale * torch.randn(*shape, generator=generator, dtype=dtype,
                                   device=device)

    return {"w1": normal(6, hidden),
            "b1": torch.zeros(hidden, dtype=dtype, device=device),
            "w2": normal(hidden, 3),
            "b2": torch.zeros(3, dtype=dtype, device=device)}


def policy_from_jax(tree, device):
    """The reference's policy parameters (arrays with `__array__`) as
    tensors on `device`, dtype kept."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def policy_apply(params, err, u_max: float, err_scale: float = 10.0):
    """err: (..., 6) Hill-frame tracking error [m, m/s] -> accel (..., 3)."""
    e = torch.cat([err[..., :3] / err_scale,
                   err[..., 3:] / (err_scale * 1e-3)], dim=-1)
    h = torch.tanh(e @ params["w1"] + params["b1"])
    return u_max * torch.tanh(h @ params["w2"] + params["b2"])


@dataclass(frozen=True)
class ControlProblem:
    design: ClusterDesign
    u_max: float = 1e-5          # [m/s^2] electric-propulsion-class authority
    control_dt: float = 60.0     # zero-order-hold interval
    substeps: int = 6            # dopri5 substeps per control interval
    dv_weight: float = 1e4       # delta-v penalty weight
    disturb: float = 0.0         # optional constant differential accel [m/s^2]


def _rhs_controlled(y, u_eci):
    r, v = y[..., :3], y[..., 3:]
    a = accel_point_mass(r) + accel_j2(r) + u_eci
    return torch.cat([v, a], dim=-1)


def _dopri5_fixed(y, u_eci, dt, substeps):
    def f(t, yy):
        return _rhs_controlled(yy, u_eci)
    for _ in range(substeps):
        y = dopri5_step(f, 0.0, y, dt)
    return y


def rollout(params, prob: ControlProblem, y0, t0: float, n_intervals: int):
    """Closed-loop rollout. y0: (N, 6) ECI. Returns (loss, diagnostics)."""
    design = prob.design
    npdt = np.float64 if y0.dtype == torch.float64 else np.float32
    ab = design.alpha_beta(y0.dtype)
    n = design.n
    center = design.n_sats // 2
    sub_dt = prob.control_dt / prob.substeps
    push = torch.as_tensor(np.sign(ab[:, :1]) * np.array([0.0, 1.0, 0.0]),
                           dtype=y0.dtype, device=y0.device)
    y, t = y0, t0
    pos_errs, dvs = [], []
    for _ in range(n_intervals):
        ref = y[center]
        hill = eci_to_hill(ref, y)
        target = torch.from_numpy(hcw_state(ab, n, t, design.kappa, npdt))
        err = hill - target.to(y.device)
        u_hill = policy_apply(params, err, prob.u_max)
        rot = hill_basis(ref[:3], ref[3:])         # Hill -> ECI
        u_eci = _rotate(u_hill, rot.T)
        u_eci = u_eci + prob.disturb * push
        y = _dopri5_fixed(y, u_eci, sub_dt, prob.substeps)
        pos_errs.append((err[..., :3] ** 2).sum())
        # safe norm: d|u|/du at u=0 is NaN otherwise, poisoning the backprop
        dvs.append(torch.sqrt((u_hill ** 2).sum(-1) + 1e-18).sum()
                   * prob.control_dt)
        t = t + prob.control_dt
    mean_err = torch.stack(pos_errs).mean() / design.n_sats
    total_dv = torch.stack(dvs).sum() / design.n_sats
    loss = mean_err + prob.dv_weight * total_dv ** 2
    return loss, {"rms_pos_err": torch.sqrt(mean_err), "dv_per_sat": total_dv,
                  "final_state": y}


def train_controller(prob: ControlProblem, n_intervals: int = 30,
                     iters: int = 40, lr: float = 3e-2, seed: int = 0,
                     perturb_scale: float = 5.0, params=None, y0=None,
                     dtype=torch.float64, *, device):
    """Train the policy by AD through the rollout.  Returns (params,
    history).

    The initial constellation is perturbed by `perturb_scale` meters of
    position noise (mm/s-scale velocity noise) so the controller has an
    error signal to remove; `params` and `y0`, where given, replace the
    drawn policy and perturbed states (the parity tests carry the
    reference's)."""
    g = torch.Generator(device).manual_seed(seed)
    if params is None:
        params = init_policy(g, dtype=dtype, device=device)
    if y0 is None:
        y0 = prob.design.initial_states(dtype, device=device)
        noise = perturb_scale * torch.randn(y0.shape, generator=g,
                                            dtype=dtype, device=device)
        noise[..., 3:] *= 1e-3
        y0 = y0 + noise
    params = {k: v.detach().clone() for k, v in params.items()}

    # minimal Adam, kept local: core does not depend on train
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    history = []
    for i in range(1, iters + 1):
        leaves = {k: p.requires_grad_() for k, p in params.items()}
        loss, _ = rollout(leaves, prob, y0, 0.0, n_intervals)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, p), gk in zip(leaves.items(), grads):
                m[k] = 0.9 * m[k] + 0.1 * gk
                v2[k] = 0.999 * v2[k] + 0.001 * gk ** 2
                mhat = m[k] / (1 - 0.9 ** i)
                vhat = v2[k] / (1 - 0.999 ** i)
                params[k] = p - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        history.append(loss.item())
    with torch.no_grad():
        _, diag = rollout(params, prob, y0, 0.0, n_intervals)
    return params, {"loss_history": history,
                    "rms_pos_err": diag["rms_pos_err"].item(),
                    "dv_per_sat": diag["dv_per_sat"].item(),
                    "y0": y0}
