"""The port's J2 numerical orbit (`repro_torch.core.orbital`: dynamics,
frames, integrators, cluster) and the liveness model's `integrate=True`
against the JAX package's, in float64, the paper's binary64 (the
reference under jax_enable_x64, as tests/test_orbital.py runs it).

Limits, each with its reason:
  - right-hand sides, rk4 and dopri5 steps and short trajectories are
    bitwise the reference's eager (unjitted) arithmetic: the same
    operations in the same order; batched frames equal single calls;
  - against the jitted reference (XLA contracts some multiply-adds) a
    step is within 1e-15 of the state's scale (1e-8 m of 7e6 m, 1e-11
    m/s of 7.5e3 m/s), and one orbit of the 81-satellite
    cluster within 1e-5 m of Hill position and 1e-8 m/s of velocity
    (rounding over ~1,200 steps at 7e6 m: 7e-14 relative);
  - frames within 1e-12 m and 1e-15 m/s (a 3 x 3 product rounded in
    another order);
  - drift rates within 1e-6 relative (least-squares slopes of positions
    that agree to 1e-7 m).
The liveness masks: with the reference's positions the port's tables and
masks are bitwise the reference's; with its own float64 orbit the masks
equal the reference's at n_pods 2, 4 and 8 over 256 rounds (the first
orbit sample is the exact HCW lattice, whose distance ties the last bit
of a 3 x 3 rotation breaks: the port spells the rotation out in the
reference's order).  The reference's own float32 orbit, as its launcher
runs it, gives other masks (ROADMAP C9)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isl as jisl  # noqa: E402
from repro.core.orbital import cluster as jc  # noqa: E402
from repro.core.orbital import dynamics as jd  # noqa: E402
from repro.core.orbital import frames as jf  # noqa: E402
from repro.core.orbital import hcw as jh  # noqa: E402
from repro.core.orbital import integrators as ji  # noqa: E402
from repro_torch.core import isl as tisl  # noqa: E402
from repro_torch.core import orbital as torb  # noqa: E402
from repro_torch.core.orbital import cluster as tc  # noqa: E402
from repro_torch.core.orbital import dynamics as td  # noqa: E402
from repro_torch.core.orbital import frames as tf  # noqa: E402
from repro_torch.core.orbital import hcw as th  # noqa: E402
from repro_torch.core.orbital import integrators as ti  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _j(fn, *args):
    """The reference run eagerly: jax's own operations one by one."""
    with jax.disable_jit():
        return np.asarray(fn(*args))


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _states(seed, n=17):
    """ECI states near the cluster's orbit: radius ~7e6 m, speed ~7.5
    km/s, in random directions."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, 3))
    r *= 7.0e6 / np.linalg.norm(r, axis=-1, keepdims=True)
    v = rng.standard_normal((n, 3)) * 7.5e3 / np.sqrt(3)
    return np.concatenate([r, v], axis=-1)


# ------------------------------------------------------------ dynamics ----

@pytest.mark.parametrize("seed", [0, 1])
def test_dynamics_match_jax_bitwise(seed):
    y = _states(seed)
    yt = _t(y)
    for want, got in (
            (_j(jd.accel_point_mass, y[:, :3]),
             td.accel_point_mass(yt[:, :3])),
            (_j(jd.accel_j2, y[:, :3]), td.accel_j2(yt[:, :3])),
            (_j(jd.make_rhs(), 0.0, y), td.make_rhs()(0.0, yt)),
            (_j(jd.make_rhs(j2=False), 0.0, y),
             td.make_rhs(j2=False)(0.0, yt)),
            (_j(jd.specific_energy, y), td.specific_energy(yt))):
        np.testing.assert_array_equal(got.numpy(), want)
    assert td.mean_motion(7.0e6) == jd.mean_motion(7.0e6)
    assert tc.mean_motion is td.mean_motion


def test_drag_matches_jax():
    """Drag goes through exp: libm's and XLA's may differ by an ulp."""
    y = _states(2)
    y[:, :3] *= (6378137.0 + 650e3) / 7.0e6
    want = _j(jd.accel_drag, y[:, :3], y[:, 3:], 0.01)
    got = td.accel_drag(_t(y[:, :3]), _t(y[:, 3:]), 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    assert (td.accel_drag(_t(y[:, :3]), _t(y[:, 3:])) == 0).all()
    want = _j(jd.make_rhs(drag_bc=0.01), 0.0, y)
    np.testing.assert_allclose(td.make_rhs(drag_bc=0.01)(0.0, _t(y)).numpy(),
                               want, rtol=1e-14, atol=0)


# -------------------------------------------------------------- frames ----

def test_frames_match_jax():
    y = _states(3, 9)
    ref, rel = y[4], _states(4, 9) * np.array([1e-4] * 3 + [1e-4] * 3)
    np.testing.assert_allclose(
        tf.hill_basis(_t(ref[:3]), _t(ref[3:])).numpy(),
        _j(jf.hill_basis, ref[:3], ref[3:]), rtol=0, atol=1e-15)
    ecis = tf.hill_to_eci(_t(ref), _t(rel)).numpy()
    want = _j(jf.hill_to_eci, ref, rel)
    np.testing.assert_allclose(ecis[:, :3], want[:, :3], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ecis[:, 3:], want[:, 3:], rtol=0, atol=1e-11)
    back = tf.eci_to_hill(_t(ref), _t(want)).numpy()
    np.testing.assert_allclose(back[:, :3], _j(jf.eci_to_hill, ref, want
                                               )[:, :3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(back, rel, rtol=0, atol=1e-6)


def test_eci_to_hill_broadcasts_over_reference_states_as_vmap():
    traj = np.stack([_states(s, 5) for s in range(4)])     # (T, N, 6)
    refs = traj[:, 2]
    want = _j(jax.vmap(jf.eci_to_hill), refs, traj)
    got = tf.eci_to_hill(_t(refs), _t(traj))
    assert got.shape == (4, 5, 6)
    for t in range(4):
        np.testing.assert_array_equal(
            got[t].numpy(), tf.eci_to_hill(_t(refs[t]), _t(traj[t])).numpy())
    np.testing.assert_allclose(got[..., :3].numpy(), want[..., :3], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got[..., 3:].numpy(), want[..., 3:], rtol=0,
                               atol=1e-11)


# --------------------------------------------------------- integrators ----

@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_steps_match_jax(method):
    y = _states(5)
    jstep = {"rk4": ji.rk4_step, "dopri5": ji.dopri5_step}[method]
    tstep = {"rk4": ti.rk4_step, "dopri5": ti.dopri5_step}[method]
    got = tstep(td.make_rhs(), 0.0, _t(y), 5.0).numpy()
    np.testing.assert_array_equal(got, _j(jstep, jd.make_rhs(), 0.0, y,
                                          5.0))
    jit = np.asarray(jax.jit(lambda yy: jstep(jd.make_rhs(), 0.0, yy, 5.0)
                             )(y))
    for c, scale in ((slice(0, 3), 7e6), (slice(3, 6), 7.5e3)):
        np.testing.assert_allclose(got[:, c], jit[:, c], rtol=0,
                                   atol=1e-15 * scale)


def test_dopri5_error_estimate_matches_jax():
    y = _states(6)
    out, err = ti.dopri5_step_err(td.make_rhs(), 0.0, _t(y), 30.0)
    with jax.disable_jit():
        jout, jerr = ji.dopri5_step_err(jd.make_rhs(), 0.0, jnp.asarray(y),
                                        30.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(
        out.numpy(), ti.dopri5_step(td.make_rhs(), 0.0, _t(y), 30.0).numpy())


def test_integrate_and_integrate_dense_match_jax():
    """40 dopri5 steps of the cluster's initial states, every 4th kept:
    bitwise the reference's eager run; trajectory[0] is y0."""
    y0 = _j(jc.ClusterDesign(n_side=3).initial_states)
    with jax.disable_jit():
        jts, jtraj = ji.integrate_dense(jd.make_rhs(), jnp.asarray(y0), 0.0,
                                        5.0, 40, stride=4)
        jfinal = ji.integrate(jd.make_rhs(), jnp.asarray(y0), 0.0, 5.0, 40)
    ts, traj = ti.integrate_dense(td.make_rhs(), _t(y0), 0.0, 5.0, 40,
                                  stride=4)
    assert traj.shape == (11, 9, 6) and torch.equal(traj[0], _t(y0))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))
    final = ti.integrate(td.make_rhs(), _t(y0), 0.0, 5.0, 40)
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal))
    assert torch.equal(final, traj[-1])
    rk = ti.integrate(td.make_rhs(), _t(y0), 0.0, 5.0, 8, method="rk4")
    with jax.disable_jit():
        jrk = ji.integrate(jd.make_rhs(), jnp.asarray(y0), 0.0, 5.0, 8,
                           method="rk4")
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))


# ------------------------------------------------------------- cluster ----

def test_design_and_initial_states_match_jax():
    jd_, td_ = jc.ClusterDesign(), tc.ClusterDesign()
    assert td_.inclination(F64) == pytest.approx(jd_.inclination(),
                                                 rel=1e-15)
    np.testing.assert_array_equal(td_.alpha_beta(F64),
                                  np.asarray(jd_.alpha_beta()))
    np.testing.assert_allclose(td_.reference_state(device=CPU).numpy(),
                               np.asarray(jd_.reference_state()), rtol=1e-15)
    for kw in ({}, {"kappa": 1.0037}, {"energy_matched": True}):
        want = np.asarray(jc.ClusterDesign(**kw).initial_states())
        got = tc.ClusterDesign(**kw).initial_states(device=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-9)
    ab = th.lattice_alpha_beta(9, 100.0, np.float64)
    for t in (0.0, 1234.5):
        np.testing.assert_allclose(
            th.hcw_state(ab, td_.n, t, 1.0037, np.float64),
            np.asarray(jh.hcw_state(jnp.asarray(ab), td_.n, t, 1.0037)),
            rtol=1e-15, atol=1e-13)


def test_the_hcw_liveness_path_keeps_its_float32_inclination():
    """The float32 rounding of the HCW path is unchanged; float64 is the
    plain arccos, ~1e-8 rad away."""
    d = tc.ClusterDesign()
    assert d.inclination() == float(np.float32(d.inclination()))
    assert d.inclination() == tc.sun_sync_inclination(d.a)
    assert 0 < abs(d.inclination(F64) - d.inclination()) < 1e-7


@pytest.fixture(scope="module")
def orbit():
    """One orbit of the 81-satellite design at dt 5 s, both packages."""
    with jax.enable_x64(True):
        jts, jhill, jrel = jc.simulate_cluster(jc.ClusterDesign(),
                                               n_orbits=1.0, dt=5.0)
        want = tuple(np.asarray(a) for a in (jts, jhill, jrel))
    return want, tc.simulate_cluster(tc.ClusterDesign(), n_orbits=1.0,
                                     dt=5.0, device=CPU)


def test_simulate_cluster_matches_jax(orbit):
    (jts, jhill, jrel), (ts, hill, rel) = orbit
    assert hill.shape == jhill.shape == (121, 81, 6)
    assert hill.dtype == F64
    np.testing.assert_array_equal(ts.numpy(), jts)
    np.testing.assert_allclose(hill[..., :3].numpy(), jhill[..., :3],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(hill[..., 3:].numpy(), jhill[..., 3:],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(rel.numpy(), jrel, rtol=0, atol=1e-5)


def test_neighbor_distances_and_closure_as_the_reference_tests(orbit):
    (_, jhill, _), (_, hill, _) = orbit
    direct, diag = torb.neighbor_distances(hill)
    jdirect, jdiag = jc.neighbor_distances(jnp.asarray(jhill))
    np.testing.assert_allclose(direct.numpy(), np.asarray(jdirect), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(diag.numpy(), np.asarray(jdiag), rtol=0,
                               atol=1e-5)
    assert 90.0 < float(direct.min()) < 110.0
    assert 190.0 < float(direct.max()) < 215.0
    assert 130.0 < float(diag.min()) < 150.0
    assert 270.0 < float(diag.max()) < 295.0
    assert float(hill[..., 2].abs().max()) < 2.0       # stays planar
    closure = (hill[-1, :, :3] - hill[0, :, :3]).norm(dim=-1)
    assert float(closure.max()) < 50.0


def test_j2_drift_rate_and_tuning_match_jax_at_two_orbits():
    """Two orbits (the CPU's share; the card runs the reference test's six
    in chip_smoke.py): the drift slopes, the annualized rate and the
    tuning table within 1e-6 relative."""
    kw = dict(n_orbits=2.0, dt=5.0)
    want = jc.secular_drift_rates(jc.ClusterDesign(), **kw)
    got = torb.secular_drift_rates(tc.ClusterDesign(), **kw, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    jbest, jtab = jc.tune_axis_ratio(jc.ClusterDesign(), kappas=(1.0, 0.999),
                                     **kw)
    best, tab = torb.tune_axis_ratio(tc.ClusterDesign(), kappas=(1.0, 0.999),
                                     **kw, device=CPU)
    assert best == jbest and list(tab) == list(jtab)
    for k in tab:
        assert tab[k] == pytest.approx(jtab[k], rel=1e-6)
    assert tab[1.0] == pytest.approx(
        torb.j2_drift_rate(tc.ClusterDesign(), **kw, device=CPU), rel=0,
        abs=0)


def test_batched_designs_equal_their_own_runs_bitwise():
    """simulate_clusters integrates several kappas at once (one launch
    count on the card); every operation is per satellite, so each slice
    is bitwise its design's own run."""
    designs = [tc.ClusterDesign(n_side=5, kappa=k) for k in (1.0, 0.999,
                                                             1.0037)]
    ts, hill, rel = torb.simulate_clusters(designs, n_orbits=0.2,
                                           samples_per_orbit=40, device=CPU)
    assert hill.shape == (9, 3, 25, 6) and rel.shape == (9, 3, 25, 3)
    for i, d in enumerate(designs):
        ts1, hill1, rel1 = tc.simulate_cluster(d, n_orbits=0.2,
                                               samples_per_orbit=40,
                                               device=CPU)
        assert torch.equal(ts, ts1)
        assert torch.equal(hill[:, i], hill1) and torch.equal(rel[:, i], rel1)
    with pytest.raises(ValueError, match="one period"):
        torb.simulate_clusters([tc.ClusterDesign(),
                                tc.ClusterDesign(altitude=700e3)],
                               device=CPU)


# ------------------------------------------------- liveness, J2 orbit ----

def _models(n_pods, **over):
    kw = dict(n_pods=n_pods, outer_wire_bytes=430_000, integrate=True)
    kw.update(over)
    return (jisl.ConstellationLinkModel(cfg=jisl.LivenessConfig(**kw)),
            tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(**kw),
                                        device=CPU))


@pytest.fixture(scope="module")
def j2_positions():
    """(S, N, 3) Hill positions of both packages' float64 J2 orbits at the
    liveness model's 64 samples."""
    with jax.enable_x64(True):
        _, jh_, _ = jc.simulate_cluster(jc.ClusterDesign(), n_orbits=1.0,
                                        samples_per_orbit=64)
        want = np.asarray(jh_[:64, :, :3])
    _, hill, _ = tc.simulate_cluster(tc.ClusterDesign(), n_orbits=1.0,
                                     samples_per_orbit=64, device=CPU)
    return want, hill[:64, :, :3].numpy()


class _Given(tisl.ConstellationLinkModel):
    """The port's model on positions handed to it."""
    positions = None

    def _positions_over_orbit(self):
        return self.positions


@pytest.mark.parametrize("n_pods", [2, 4, 8])
def test_integrated_liveness_on_the_reference_positions_is_bitwise(
        j2_positions, n_pods):
    want_pos, _ = j2_positions
    cfg = dict(n_pods=n_pods, outer_wire_bytes=430_000, integrate=True)
    with jax.enable_x64(True):
        j = jisl.ConstellationLinkModel(cfg=jisl.LivenessConfig(**cfg))
    _Given.positions = want_pos
    t = _Given(cfg=tisl.LivenessConfig(**cfg))
    assert t._pod_bw.tobytes() == j._pod_bw.tobytes()
    assert t._sync_s.tobytes() == j._sync_s.tobytes()
    assert t.round_deadline_s == j.round_deadline_s
    np.testing.assert_array_equal(t.mask_series(256)[0],
                                  j.mask_series(256)[0])


@pytest.mark.parametrize("n_pods", [2, 4, 8])
def test_integrated_liveness_masks_equal_jax_float64(j2_positions, n_pods):
    """The port's own float64 orbit: positions within 1e-5 m of the
    reference's, masks equal over 256 rounds."""
    want_pos, got_pos = j2_positions
    np.testing.assert_allclose(got_pos, want_pos, rtol=0, atol=1e-5)
    with jax.enable_x64(True):
        j, t = _models(n_pods)
    masks, jmasks = t.mask_series(256)[0], j.mask_series(256)[0]
    np.testing.assert_array_equal(masks, jmasks)
    _Given.positions = got_pos
    again = _Given(cfg=tisl.LivenessConfig(
        n_pods=n_pods, outer_wire_bytes=430_000, integrate=True))
    np.testing.assert_array_equal(again.mask_series(256)[0], masks)


def test_integrated_liveness_float32_reference_is_set_by_rounding(
        j2_positions):
    """The reference's launcher runs its orbit in float32 (x64 off), where
    an ulp at 7e6 m is 0.5 m: at n_pods 8 its masks differ from its own
    float64 run's, and so from the port's, in 309 of 2,048 entries."""
    with jax.enable_x64(False):
        j32, _ = (jisl.ConstellationLinkModel(cfg=jisl.LivenessConfig(
            n_pods=8, outer_wire_bytes=430_000, integrate=True)), None)
        m32 = j32.mask_series(256)[0]
    with jax.enable_x64(True):
        j64, t = _models(8)
    m64 = j64.mask_series(256)[0]
    assert int((m32 != m64).sum()) == 309
    assert int((t.mask_series(256)[0] != m32).sum()) == 309


def test_integrated_liveness_keeps_the_hcw_model_invariants():
    t = tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(
        n_pods=2, outer_wire_bytes=430_000, integrate=True), device=CPU)
    assert t._pod_bw.shape == (64, 2) and (t._pod_bw > 0).all()
    for r in range(20):
        alive, weights, _ = t.serving_mask(r)
        assert (alive == (t.mask_at(r)[0] > 0)).all()
