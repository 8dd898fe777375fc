"""The port's chaos schedules against the JAX package's (`serving/chaos.py`
in both, numpy only): the outage grammar and its rejects, schedule
validation, and overlays tick by tick (scheduled strikes, busiest-pod
resolution, the seeded random process, underlying masks) equal to the
reference's for the same schedules and inputs; plus the launchers'
chaos smokes on the CPU, each checking the zero-drop outage contract."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving.router import ForcedOutage as JForcedOutage  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402
from repro_torch.serving import ForcedOutage  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _events(sched):
    return [(e.at_tick, e.pod, e.ticks) for e in sched.events]


# ------------------------------------------------------------- grammar ----

@pytest.mark.parametrize("spec", ["3", "2:*:3", "2:0:3, 6:1:3", "5:2", "2:1",
                                  "0:*", "4::2", "1:*:", " 7 : 1 : 2 ",
                                  "2:1:3,10:1:3", "2:1,2:2", "0:0:10,2:2:2"])
def test_grammar_matches_reference(spec):
    want, got = jchaos.parse_outage_spec(spec), tchaos.parse_outage_spec(spec)
    assert _events(got) == _events(want)
    assert got.has_repair == want.has_repair
    assert (got.random_rate, got.random_ticks, got.seed) == \
        (want.random_rate, want.random_ticks, want.seed)


@pytest.mark.parametrize("bad", ["", "x", "2:1:0", "2:1:3:4", "2,,3", "a:1",
                                 "2:b", "2:1:-1", ":1:2"])
def test_grammar_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jchaos.parse_outage_spec(bad)
    with pytest.raises(ValueError):
        tchaos.parse_outage_spec(bad)


@pytest.mark.parametrize("kw,exc", [(dict(events=("not-an-event",)),
                                     TypeError),
                                    (dict(random_rate=1.5), ValueError),
                                    (dict(random_rate=-0.1), ValueError),
                                    (dict(random_rate=1.0), ValueError)])
def test_schedule_validation_matches_reference(kw, exc):
    for mod in (jchaos, tchaos):
        with pytest.raises(exc):
            mod.ChaosSchedule(**kw)


# ------------------------------------------------------------- overlay ----

def _schedules(mod):
    ev = mod.ChaosEvent
    return {
        "busiest-waits": mod.parse_outage_spec("1:*:2"),
        "overlap": mod.parse_outage_spec("0:0:10,2:1:2"),
        "single-strike": mod.parse_outage_spec("3"),
        "two-cycles": mod.parse_outage_spec("2:*:3,9:1:3"),
        "two-pods-at-once": mod.parse_outage_spec("2:0,2:1"),
        "random": mod.ChaosSchedule(random_rate=0.3, random_ticks=2, seed=7),
        "random+scheduled": mod.ChaosSchedule(
            events=(ev(at_tick=3, pod=None, ticks=2),), random_rate=0.2,
            random_ticks=3, seed=11),
    }


@pytest.mark.parametrize("n_pods", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(_schedules(tchaos)))
def test_overlay_matches_reference_tick_by_tick(name, n_pods):
    """Random busy counts (idle ticks included) and an underlying mask
    with dark pods: the overlaid masks and the resolved strikes equal the
    reference's at every tick."""
    want_s, got_s = _schedules(jchaos)[name], _schedules(tchaos)[name]
    rng = np.random.default_rng(n_pods * 31 + len(name))
    st_j, st_t = {}, {}
    for tick in range(16):
        busy = rng.integers(0, 3, n_pods) * (rng.random() > 0.2)
        alive = rng.random(n_pods) > 0.15
        want = want_s.overlay(st_j, tick, alive, busy)
        got = got_s.overlay(st_t, tick, alive, busy)
        np.testing.assert_array_equal(got, want, err_msg=f"tick {tick}")
        assert got.dtype == want.dtype == bool
        assert st_t == st_j
    assert st_t or name.startswith("random")


def test_overlay_resolution_waits_for_work_and_sticks():
    s = tchaos.parse_outage_spec("1:*:2")
    st, alive = {}, np.ones(3, bool)
    np.testing.assert_array_equal(s.overlay(st, 1, alive, [0, 0, 0]), alive)
    assert st == {}
    np.testing.assert_array_equal(s.overlay(st, 2, alive, [1, 2, 2]),
                                  [True, False, True])
    np.testing.assert_array_equal(s.overlay(st, 3, alive, [5, 0, 0]),
                                  [True, False, True])
    np.testing.assert_array_equal(s.overlay(st, 4, alive, [5, 0, 0]), alive)


def test_forced_outage_normalization_matches_reference():
    assert tchaos.as_chaos_schedule(None) is None
    s = tchaos.parse_outage_spec("2:*:3")
    assert tchaos.as_chaos_schedule(s) is s
    for args in ((4, 1, 2), (2, None, None), (0, 0, 5)):
        got = tchaos.as_chaos_schedule(ForcedOutage(*args))
        want = jchaos.as_chaos_schedule(JForcedOutage(*args))
        assert _events(got) == _events(want) == [args]
    with pytest.raises(TypeError, match="ForcedOutage or"):
        tchaos.as_chaos_schedule(42)


# ------------------------------------------------- the launchers' smokes ----

def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--device",
         "cpu", *args], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=240)


@pytest.mark.parametrize("args,flips", [
    (("--replicas", "2", "--slots", "3", "--max-len", "64", "--requests",
      "6", "--max-new-tokens", "48", "--waves", "2", "--force-outage-at",
      "2:1:3,10:1:3", "--expect-pointer-flip", "--expect-rebalance"), True),
    (("--replicas", "3", "--slots", "2", "--max-len", "64", "--requests",
      "9", "--max-new-tokens", "12", "--full-drain", "--force-outage-at",
      "3"), False),
    (("--replicas", "2", "--slots", "16", "--max-len", "64", "--page-size",
      "16", "--pool-pages", "64", "--prefix-cache", "8", "--requests", "36",
      "--max-new-tokens", "48", "--force-outage-at", "2:1:3,10:1:3",
      "--expect-pointer-flip"), True),
    (("--arch", "suncatcher-lm-100m,recurrentgemma-2b", "--replicas", "2",
      "--requests", "8", "--max-len", "64", "--max-new-tokens", "32",
      "--force-outage-at", "2:*:3", "--expect-pointer-flip"), True),
], ids=["chaos-cycles", "full-drain", "paged", "mixed"])
def test_serve_cli_plane_keeps_the_outage_contract(args, flips):
    proc = _cli("serve", *args)
    assert proc.returncode == 0, proc.stderr
    assert "zero drops" in proc.stdout
    line = next(ln for ln in proc.stdout.splitlines() if "grid of" in ln)
    n_flips = int(line.split(" pointer flips")[0].rsplit("| ", 1)[1])
    assert (n_flips > 0) == flips, line


def test_serve_cli_plane_refusals():
    proc = _cli("serve", "--force-outage-at", "2")
    assert proc.returncode != 0 and "needs --replicas >= 2" in proc.stderr
    proc = _cli("serve", "--arch", "suncatcher-lm-100m,recurrentgemma-2b")
    assert proc.returncode != 0 and "needs --replicas >= 2" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_coserve_cli_plane_fails_over_and_swaps_in_lockstep():
    proc = _cli("coserve", "--steps", "16", "--replicas", "2",
                "--max-new-tokens", "24", "--force-outage-at", "2")
    assert proc.returncode == 0, proc.stderr
    assert "serve: plane of 2 replicas" in proc.stdout
    assert "plane-wide param swaps (v3)" in proc.stdout
    assert "outage '2': zero drops" in proc.stdout
