"""The port's formation controller (`repro_torch.core.orbital.control`)
against the JAX package's, in float64 (the reference under
jax_enable_x64, as tests/test_control.py runs it), on the reference
test's problem: a 3 x 3 lattice, u_max 2e-5, 60 s intervals of 4 dopri5
substeps, dv_weight 1e3.

The policy's initial draws and the perturbed initial states are the
reference's, carried across (`policy_from_jax`, an explicit y0): the
port does not reproduce jax's normal sampler.  Limits: the policy within
1e-14 relative (libm's and XLA's tanh differ by ulps); rollout losses
within 1e-10 and gradients within 1e-9 relative; a short training run's
loss history, rms_pos_err and dv_per_sat within 1e-8 relative (measured:
~1e-10 over the reference test's 25 iterations)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.orbital import cluster as jc  # noqa: E402
from repro.core.orbital import control as jctl  # noqa: E402
from repro_torch.core.orbital import ControlProblem, rollout  # noqa: E402
from repro_torch.core.orbital import cluster as tc  # noqa: E402
from repro_torch.core.orbital import control as tctl  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _problems():
    kw = dict(u_max=2e-5, control_dt=60.0, substeps=4, dv_weight=1e3)
    return (jctl.ControlProblem(design=jc.ClusterDesign(n_side=3,
                                                        spacing=100.0), **kw),
            ControlProblem(design=tc.ClusterDesign(n_side=3, spacing=100.0),
                           **kw))


@pytest.fixture(scope="module")
def start():
    """The reference's initial policy and perturbed states (seed 0,
    perturb_scale 8), as `train_controller` draws them."""
    with jax.enable_x64(True):
        kp, kn = jax.random.split(jax.random.PRNGKey(0))
        params = jctl.init_policy(kp)
        jprob, _ = _problems()
        y0 = jprob.design.initial_states()
        noise = 8.0 * jax.random.normal(kn, y0.shape, y0.dtype)
        y0 = np.asarray(y0 + noise.at[..., 3:].multiply(1e-3))
    return params, y0


def test_policy_matches_jax_and_respects_its_authority(start):
    params, _ = start
    err = 1e3 * np.random.default_rng(2).standard_normal((17, 6))
    want = np.asarray(jctl.policy_apply(params, jnp.asarray(err), 2e-5))
    got = tctl.policy_apply(tctl.policy_from_jax(params, CPU),
                            torch.from_numpy(err), 2e-5)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    assert float(got.abs().max()) <= 2e-5 + 1e-12


def test_init_policy_shapes_and_generator():
    a = tctl.init_policy(torch.Generator().manual_seed(1), device=CPU)
    b = tctl.init_policy(torch.Generator().manual_seed(1), device=CPU)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w1": (6, 32), "b1": (32,), "w2": (32, 3), "b2": (3,)}
    assert all(v.dtype == torch.float64 and torch.equal(v, b[k])
               for k, v in a.items())
    assert not a["b1"].any() and a["w1"].std() < 0.2


def test_rollout_loss_and_gradients_match_jax(start):
    params, y0 = start
    jprob, tprob = _problems()
    (jloss, jdiag), jgrad = jax.value_and_grad(
        lambda p: jctl.rollout(p, jprob, jnp.asarray(y0), 0.0, 5),
        has_aux=True)(params)
    tp = {k: v.requires_grad_() for k, v in tctl.policy_from_jax(
        params, CPU).items()}
    loss, diag = rollout(tp, tprob, torch.tensor(y0), 0.0, 5)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-10)
    for key in ("rms_pos_err", "dv_per_sat"):
        assert diag[key].item() == pytest.approx(float(jdiag[key]), rel=1e-10)
    np.testing.assert_allclose(diag["final_state"].detach().numpy(),
                               np.asarray(jdiag["final_state"]), rtol=1e-13)
    for k, g in zip(tp, grads):
        want = np.asarray(jgrad[k])
        assert np.isfinite(g.numpy()).all() and np.abs(g.numpy()).max() > 0
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_gradients_are_finite_at_zero_thrust(start):
    """The safe norm: an all-zero policy commands u = 0 exactly, where a
    plain |u| has a NaN gradient."""
    _, y0 = start
    _, tprob = _problems()
    zero = {k: torch.zeros_like(v).requires_grad_() for k, v in
            tctl.init_policy(torch.Generator().manual_seed(0),
                             device=CPU).items()}
    loss, diag = rollout(zero, tprob, torch.tensor(y0), 0.0, 3)
    # each satellite's |u| is sqrt(1e-18) = 1e-9 over 3 intervals of 60 s
    assert diag["dv_per_sat"].item() == pytest.approx(3 * 60 * 1e-9,
                                                      rel=1e-9)
    grads = torch.autograd.grad(loss, list(zero.values()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_train_controller_matches_jax_from_carried_parameters(start):
    """Six iterations of Adam through 20-interval rollouts from the
    reference's draws: the same loss history, final rms error, delta-v
    and parameters (the card runs the reference test's 25 iterations in
    chip_smoke.py)."""
    params, y0 = start
    jprob, tprob = _problems()
    jparams, jinfo = jctl.train_controller(jprob, n_intervals=20, iters=6,
                                           lr=3e-2, perturb_scale=8.0)
    np.testing.assert_array_equal(np.asarray(jinfo["y0"]), y0)
    tparams, info = tctl.train_controller(
        tprob, n_intervals=20, iters=6, lr=3e-2,
        params=tctl.policy_from_jax(params, CPU), y0=torch.tensor(y0),
        device=CPU)
    np.testing.assert_allclose(info["loss_history"], jinfo["loss_history"],
                               rtol=1e-8)
    assert info["loss_history"][-1] < info["loss_history"][0]
    for key in ("rms_pos_err", "dv_per_sat"):
        assert info[key] == pytest.approx(jinfo[key], rel=1e-8)
    for k, v in tparams.items():
        want = np.asarray(jparams[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max())
    assert torch.equal(info["y0"], torch.tensor(y0))
