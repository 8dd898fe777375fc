"""The port's launch economics, system spec and roofline terms
(`repro_torch.core.economics`, `core/system.py`, `analysis/roofline.py`)
against the JAX package's.

Limits: every function, property, constant and Table 1 row is host numpy
float64 in both packages, the same expressions in the same order, so they
are held equal (==), as is `SpaceCluster().summary()` key by key.  The
roofline terms are equal at the default chip; at `H100_SXM` the port's
`mfu` divides by the H100's peak and the reference's by its default
chip's (ROADMAP C11), which this file pins."""
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import economics as jeco  # noqa: E402
from repro.core import system as jsys  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.core import economics as teco  # noqa: E402
from repro_torch.core import system as tsys  # noqa: E402

# the modules (each package's `analysis` exports a function of that name)
jroof = importlib.import_module("repro.analysis.roofline")
troof = importlib.import_module("repro_torch.analysis.roofline")
TARGETS = (100.0, 200.0, 300.0, 1000.0, 1800.0)
REUSES = (0, 1, 2, 10, 100)


def test_constants_and_history_equal():
    for name in ("CURRENT_LAUNCH_USD_PER_KG", "TARGET_LAUNCH_USD_PER_KG",
                 "TERRESTRIAL_RANGE", "SPACEX_HISTORY"):
        assert getattr(teco, name) == getattr(jeco, name), name
    from repro.core.economics import power_price as jpp
    from repro_torch.core.economics import power_price as tpp
    assert (tpp.SOLAR_INSOLATION_KW_M2, tpp.HOURS_PER_YEAR) == \
        (jpp.SOLAR_INSOLATION_KW_M2, jpp.HOURS_PER_YEAR)


@pytest.mark.parametrize("kw", [
    {}, {"learning_rate": 0.18},
    {"p0_usd_per_kg": 2000.0, "cum0_tonnes": 300.0}])
def test_learning_curve_equal(kw):
    t, j = teco.LearningCurve(**kw), jeco.LearningCurve(**kw)
    assert t.exponent == j.exponent
    cum = np.array([0.5, 10.0, 150.0, 400.0, 8e3, 3.7e5])
    np.testing.assert_array_equal(t.price(cum), j.price(cum))
    assert t.price(400.0) == j.price(400.0)
    for p in TARGETS:
        assert t.cumulative_mass_for_price(p) == \
            j.cumulative_mass_for_price(p)
        assert t.additional_mass_for_price(p) == \
            j.additional_mass_for_price(p)
        assert t.starship_launches_for_price(p, 150.0) == \
            j.starship_launches_for_price(p, 150.0)
        assert t.year_reached(p) == j.year_reached(p)
        assert t.year_reached(p, 90.0, 100.0, 2030.0) == \
            j.year_reached(p, 90.0, 100.0, 2030.0)


@pytest.mark.parametrize("kw", [{}, {"vehicle_cost": 50e6,
                                     "refurb_frac_per_launch": 0.02}])
def test_starship_cost_model_equal(kw):
    t, j = teco.StarshipCostModel(**kw), jeco.StarshipCostModel(**kw)
    for n in REUSES:
        assert t.cost_per_launch(n) == j.cost_per_launch(n)
        assert t.cost_per_kg(n) == j.cost_per_kg(n)
        for margin in (0.0, 0.5, 0.75):
            assert t.price_per_kg(n, margin) == j.price_per_kg(n, margin)
    assert t.propellant_floor_per_kg() == j.propellant_floor_per_kg()


def test_table1_rows_and_power_functions_equal():
    assert len(teco.TABLE1_SATELLITES) == len(jeco.TABLE1_SATELLITES) == 4
    for t, j in zip(teco.TABLE1_SATELLITES, jeco.TABLE1_SATELLITES):
        assert (t.name, t.mass_kg, t.power_kw, t.lifespan_years) == \
            (j.name, j.mass_kg, j.power_kw, j.lifespan_years)
        for price in (teco.CURRENT_LAUNCH_USD_PER_KG,
                      teco.TARGET_LAUNCH_USD_PER_KG, 20.0):
            assert t.launched_power_price(price) == \
                j.launched_power_price(price)
    assert teco.starlink_v2_power_kw() == jeco.starlink_v2_power_kw()
    assert teco.starlink_v2_power_kw(80.0, 0.3, 0.8) == \
        jeco.starlink_v2_power_kw(80.0, 0.3, 0.8)
    for kwh, pue in ((0.06, 1.09), (0.25, 1.4), (0.1, 1.2)):
        assert teco.terrestrial_power_cost_per_kw_year(kwh, pue) == \
            jeco.terrestrial_power_cost_per_kw_year(kwh, pue)


def test_chip_spec_defaults_are_the_papers_modelled_chip():
    assert dataclasses.asdict(tsys.ChipSpec()) == \
        dataclasses.asdict(jsys.ChipSpec())
    # the card's data-sheet figures, the ones chip_smoke.py prices its
    # kernel bounds at
    assert (H100_SXM.peak_bf16_flops, H100_SXM.hbm_bytes_per_s,
            H100_SXM.power_w) == (989e12, 3.35e12, 700.0)


@pytest.mark.parametrize("chip", ["default", "h100"])
def test_satellite_spec_equal(chip):
    kw, jkw = {}, {}
    if chip == "h100":
        kw = {"chip": H100_SXM}
        jkw = {"chip": jsys.ChipSpec(**dataclasses.asdict(H100_SXM))}
    t, j = tsys.SatelliteSpec(**kw), jsys.SatelliteSpec(**jkw)
    assert (t.mass_kg, t.compute_power_kw) == (j.mass_kg, j.compute_power_kw)
    tb, jb = t.as_bus(), j.as_bus()
    assert (tb.name, tb.mass_kg, tb.power_kw, tb.lifespan_years) == \
        (jb.name, jb.mass_kg, jb.power_kw, jb.lifespan_years)


@pytest.mark.parametrize("n_sats", [81, 16])
def test_space_cluster_summary_equal_key_by_key(n_sats):
    t, j = tsys.SpaceCluster(n_satellites=n_sats), \
        jsys.SpaceCluster(n_satellites=n_sats)
    ts, js = t.summary(), j.summary()
    assert list(ts) == list(js)
    for k in js:
        assert ts[k] == js[k], k
        assert type(ts[k]) is type(js[k]), k
    assert (t.total_chips, t.peak_flops) == (j.total_chips, j.peak_flops)
    for cons in (True, False):
        assert t.pod_axis_bandwidth_bytes(cons) == \
            j.pod_axis_bandwidth_bytes(cons)
    for step in (0.5, 1.0, 30.0):
        assert t.expected_sdc_per_step(step) == j.expected_sdc_per_step(step)
    for cost in (10.0, 30.0, 120.0):
        assert t.checkpoint_interval_s(cost) == j.checkpoint_interval_s(cost)
    for price in (3600.0, 200.0, 20.0):
        assert t.launch_cost_usd(price) == j.launch_cost_usd(price)
        assert t.launched_power_price(price) == j.launched_power_price(price)


def _terms(mod, chip):
    ca = {"flops": 3.1e15, "bytes accessed": 2.2e11}
    kw = {} if chip is None else {"chip": chip}
    return mod.roofline(ca, 4.0e9, chips=8, model_flops=1.9e16,
                        pod_axis_bytes=1.0e9, **kw)


def test_roofline_terms_equal_at_the_default_chip():
    t, j = _terms(troof, None), _terms(jroof, None)
    for name in ("compute_s", "memory_s", "collective_s", "flops_per_device",
                 "bytes_per_device", "wire_bytes_per_device", "model_flops",
                 "chips", "dominant", "step_time_s", "utility_ratio", "mfu"):
        assert getattr(t, name) == getattr(j, name), name
    # the reference's model_flops_for is the port's useful_flops (decode
    # counts one token per sequence)
    from repro.models import registry as jr
    from repro_torch.analysis import useful_flops
    from repro_torch.models import registry as tr
    for arch in ("suncatcher-lm-100m", "granite-moe-1b-a400m"):
        tc, jc = tr.get_config(arch), jr.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            tokens = 8 * (1024 if kind != "decode" else 1)
            assert useful_flops(tc, kind, 8, 1024) == \
                jroof.model_flops_for(jc, kind, tokens)


def test_roofline_mfu_uses_the_chip_it_was_priced_for():
    """ROADMAP C11: priced at H100_SXM, every term agrees with the
    reference's, but the reference's mfu divides by its default chip's
    peak (197e12) and the port's by the H100's (989e12)."""
    t = _terms(troof, H100_SXM)
    j = _terms(jroof, jsys.ChipSpec(**dataclasses.asdict(H100_SXM)))
    for name in ("compute_s", "memory_s", "collective_s", "step_time_s",
                 "dominant", "utility_ratio"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.chip == H100_SXM
    want = t.model_flops / (t.step_time_s * H100_SXM.peak_bf16_flops * 8)
    assert t.mfu == pytest.approx(want, rel=1e-15)
    wrong = t.model_flops / (t.step_time_s * jsys.ChipSpec().peak_bf16_flops
                             * 8)
    assert j.mfu == pytest.approx(wrong, rel=1e-15)
    assert j.mfu == pytest.approx(t.mfu * 989e12 / 197e12, rel=1e-12)
