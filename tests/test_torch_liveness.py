"""The port's constellation liveness model and the physics it stands on
(`repro_torch.core`: orbital, radiation, isl) against the JAX package's.

`ConstellationLinkModel` is checked three ways:
  - given the reference's positions, its bandwidths, sync times,
    deadline and masks are the reference's bitwise (the link budget,
    topology and outage draws are copies, numpy on numpy);
  - its own float32 HCW positions are within rtol 1e-6 of the
    reference's (sin and cos are rounded correctly in the port, while
    XLA's float32 versions may be an ulp off);
  - its pod masks equal the reference's over 256 rounds at n_pods 2, 4
    and 8.  Masks, not bandwidths: the neighbour graph breaks exact
    distance ties by the last bit of a position (ROADMAP C5).
Then the reference's own invariants (tests/test_liveness.py) on the port.

The reference runs with jax's default 32-bit types (other test modules
turn on jax_enable_x64 process-wide, under which its orbit is float64)."""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isl as jisl  # noqa: E402
from repro.core.orbital import cluster as jcluster  # noqa: E402
from repro.core.orbital import hcw as jhcw  # noqa: E402
from repro.core.radiation import seu as jseu  # noqa: E402
from repro_torch.core import isl as tisl  # noqa: E402
from repro_torch.core.orbital import cluster as tcluster  # noqa: E402
from repro_torch.core.orbital import hcw as thcw  # noqa: E402
from repro_torch.core.radiation import seu as tseu  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _models(**overrides):
    kw = dict(n_pods=2, outer_wire_bytes=430_000)
    kw.update(overrides)
    return (jisl.ConstellationLinkModel(cfg=jisl.LivenessConfig(**kw)),
            tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(**kw)))


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


# ------------------------------------------------- parity with the JAX ----

def test_cluster_design_matches_jax():
    j, t = jcluster.ClusterDesign(), tcluster.ClusterDesign()
    assert (t.a, t.n, t.period, t.n_sats) == (j.a, j.n, j.period, j.n_sats)
    assert t.inclination() == pytest.approx(j.inclination(), rel=1e-6)
    assert _bits(t.alpha_beta()) == _bits(j.alpha_beta())
    assert _bits(thcw.lattice_alpha_beta(5, 37.5)) == \
        _bits(jhcw.lattice_alpha_beta(5, 37.5))
    assert thcw.neighbor_pairs(7) == jhcw.neighbor_pairs(7)


@pytest.mark.parametrize("kappa", [1.0, 1.0037])
def test_hcw_state_within_rtol_of_jax(kappa):
    d = tcluster.ClusterDesign()
    ab = d.alpha_beta()
    for t in np.linspace(0.0, d.period, 64, endpoint=False):
        want = np.asarray(jhcw.hcw_state(ab, d.n, t, kappa))
        got = thcw.hcw_state(ab, d.n, t, kappa)
        assert got.dtype == want.dtype == np.float32
        for c in range(6):
            np.testing.assert_allclose(
                got[:, c], want[:, c], rtol=1e-6,
                atol=1e-6 * np.abs(want[:, c]).max())


def test_hcw_propagate_within_rtol_of_jax():
    rng = np.random.default_rng(0)
    s0 = (rng.standard_normal((9, 6)) * [100, 100, 10, 0.1, 0.1, 0.01]
          ).astype(np.float32)
    n = tcluster.ClusterDesign().n
    for t in (0.0, 17.0, 900.0, 5000.0):
        want = np.asarray(jhcw.hcw_propagate(s0, n, t))
        got = thcw.hcw_propagate(s0, n, t)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_radiation_and_link_budget_match_jax():
    je, te = jseu.RadiationEnvironment(), tseu.RadiationEnvironment()
    for dose in (jseu.SDC_DOSE_PER_EVENT_RAD, jseu.SEFI_DOSE_PER_EVENT_RAD,
                 jseu.HBM_UECC_DOSE_PER_EVENT_RAD):
        assert te.rate_per_chip_second(dose) == je.rate_per_chip_second(dose)
        assert tseu.cross_section_cm2(dose) == jseu.cross_section_cm2(dose)
    assert te.optimal_checkpoint_interval_s(1000, 30.0) == \
        je.optimal_checkpoint_interval_s(1000, 30.0)
    d = np.array([50.0, 150.0, 320.0, 1250.0, 5e3, 5e6])
    assert _bits(tisl.OpticalTerminal().aggregate_bandwidth_bps(d)) == \
        _bits(jisl.OpticalTerminal().aggregate_bandwidth_bps(d))


def test_neighbor_graph_matches_jax_on_the_same_positions():
    d = jcluster.ClusterDesign()
    pos = np.asarray(jhcw.hcw_state(d.alpha_beta(), d.n, 700.0)[..., :3])
    je, jc = jisl.ISLNetwork().neighbor_graph(pos)
    te, tc = tisl.ISLNetwork().neighbor_graph(pos)
    assert _bits(te) == _bits(je) and _bits(tc) == _bits(jc)
    assert tisl.pod_axis_bandwidth_bytes(pos) == \
        jisl.pod_axis_bandwidth_bytes(pos)


@pytest.mark.parametrize("n_pods", [1, 2, 4, 8])
def test_link_model_on_the_reference_positions_is_bitwise(n_pods):
    """Fed the reference's float32 orbit, the port's model is the
    reference's: bandwidths, sync times, deadline and 64 rounds of masks,
    outage draws and admission weights."""
    jm = jisl.ConstellationLinkModel(cfg=jisl.LivenessConfig(
        n_pods=n_pods, outer_wire_bytes=430_000))
    positions = jm._positions_over_orbit()

    class OnReferenceOrbit(tisl.ConstellationLinkModel):
        def _positions_over_orbit(self):
            return positions

    tm = OnReferenceOrbit(cfg=tisl.LivenessConfig(
        n_pods=n_pods, outer_wire_bytes=430_000))
    assert _bits(tm._pod_bw) == _bits(jm._pod_bw)
    assert _bits(tm._sync_s) == _bits(jm._sync_s)
    assert tm.round_deadline_s == jm.round_deadline_s
    assert tm.repair_rounds == jm.repair_rounds
    for r in range(64):
        (tmask, tinfo), (jmask, jinfo) = tm.mask_at(r), jm.mask_at(r)
        assert _bits(tmask) == _bits(jmask), r
        for k in ("straggler", "outage", "pod_bandwidth_bps"):
            assert _bits(tinfo[k]) == _bits(jinfo[k]), (r, k)
        for a, b in zip(tm.serving_mask(r), jm.serving_mask(r)):
            if not isinstance(a, dict):
                assert _bits(a) == _bits(b)


@pytest.mark.parametrize("n_pods", [2, 4, 8])
def test_masks_equal_jax_over_256_rounds(n_pods):
    jm, tm = _models(n_pods=n_pods)
    want, jstats = jm.mask_series(256)
    got, tstats = tm.mask_series(256)
    assert _bits(got) == _bits(want)
    assert tstats == jstats
    pos_t = tm._positions_over_orbit()
    pos_j = jm._positions_over_orbit()
    np.testing.assert_allclose(pos_t, pos_j, rtol=1e-6,
                               atol=1e-6 * np.abs(pos_j).max())


def test_outage_draws_equal_jax_under_a_high_rate():
    jm, tm = _models(n_pods=4, outage_rate_multiplier=3e3)
    for r in range(40):
        assert _bits(tm.outage_events(r)) == _bits(jm.outage_events(r))
        assert _bits(tm.outage_mask(r)) == _bits(jm.outage_mask(r))


def test_admission_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(1, 7))
        alive = rng.random(n) < 0.6
        w = rng.random(n) * (rng.random(n) < 0.8)
        room = rng.random(n) < 0.7
        assert _bits(tisl.liveness.normalize_admission_weights(alive, w)) \
            == _bits(jisl.liveness.normalize_admission_weights(alive, w))
        for primary in range(n):
            assert tisl.choose_standby_pod(primary, alive, w, room) == \
                jisl.choose_standby_pod(primary, alive, w, room)


# ---------------------------------------------- the port's own contracts --

@pytest.fixture(scope="module")
def model():
    return tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(
        n_pods=2, outer_wire_bytes=430_000))


def test_mask_is_pure_and_deterministic_across_instances(model):
    other = tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(
        n_pods=2, outer_wire_bytes=430_000))
    for r in range(26):
        a, _ = model.mask_at(r)
        assert a.dtype == np.float32
        assert a.tobytes() == other.mask_at(r)[0].tobytes() == \
            model.mask_at(r)[0].tobytes()
    bw = model._pod_bw
    assert bw.min() > 0 and bw.max() / bw.min() > 1.2


def test_deadline_bounds_and_quiet_radiation():
    def mk(**kw):
        return tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(
            n_pods=2, outer_wire_bytes=430_000, **kw))
    lax = mk(round_deadline_s=np.inf, outage_rate_multiplier=0.0)
    tight = mk(round_deadline_s=1e-30, outage_rate_multiplier=0.0)
    for r in range(20):
        m_lax, i_lax = lax.mask_at(r)
        m_tight, i_tight = tight.mask_at(r)
        assert not i_lax["straggler"].any() and (m_lax == 1.0).all()
        assert i_tight["straggler"].all() and (m_tight == 0.0).all()
        assert not lax.outage_mask(r).any()


def test_outage_repair_window_and_series(model):
    hit = next(((r, int(np.argmax(model.outage_events(r) > 0)))
                for r in range(200) if model.outage_events(r).any()), None)
    assert hit is not None, "no outage in 200 rounds at paper rates"
    r, p = hit
    for rr in range(r, r + model.repair_rounds):
        assert model.outage_mask(rr)[p]
    masks, stats = model.mask_series(32)
    assert masks.shape == (32, 2)
    assert stats["mask_transitions"] == int((masks[1:] != masks[:-1]).sum())
    assert stats["mask_transitions"] >= 1
    assert model._pod_of.shape == (81,) and set(model._pod_of) == {0, 1}
    solo = tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(n_pods=1))
    assert solo._pod_bw.shape[1] == 1 and (solo._pod_bw > 0).all()


def test_j2_orbit_is_refused_with_its_roadmap_item():
    """integrate=True builds the model on the J2 orbit (its parity with
    the reference: tests/test_torch_orbital.py); a bad pod count is
    refused."""
    m = tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(integrate=True),
                                    device="cpu")
    assert m._pod_bw.shape == (64, 2) and np.isfinite(m._sync_s).all()
    with pytest.raises(ValueError):
        tisl.ConstellationLinkModel(cfg=tisl.LivenessConfig(n_pods=0))
