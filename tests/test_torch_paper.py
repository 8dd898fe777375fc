"""The port's paper entries (`repro_torch.paper`) against the reference's
`benchmarks/` entries: the host entries (Fig. 1, Fig. 4, Table 1, the
radiation table), the DiLoCo ISL traffic and constellation liveness, and
the runner (`python -m repro_torch.paper`).  The orbit entries (Fig. 2,
the J2 drift) are in tests/test_torch_paper_orbit.py.

Limits, each with its reason:
  - host entries: rows and derived lines equal.  Both are host numpy
    float64, the same expressions in the same order.
  - DiLoCo traffic rows and the ISL line: equal (integer param counts
    through the same float arithmetic).
  - the micro DiLoCo run under constellation masks (`_constellation_stats`,
    the port starting from the reference's params through
    `params_from_jax`): every mask count, the orbit profile, the round
    time and deadline equal; first and last loss within 2^-8 relative (one
    bf16 ulp: both packages compute the reduced demo LM in bf16, and
    their matmuls and attention round differently; measured 9.3e-5 and
    9.3e-4 relative).
  - the derived lines of `run()`: equal, given the same constellation
    stats.
The reference runs with jax's default 32-bit types (its liveness model's
HCW orbit is float32 there; other test modules turn x64 on process-wide).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as jr  # noqa: E402
from repro_torch.models import registry as tr  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.paper import ENTRIES, ON_DEVICE  # noqa: E402
from repro_torch.paper import __main__ as runner  # noqa: E402
from repro_torch.paper import diloco_traffic as tdt  # noqa: E402
from repro_torch.paper import (fig1_isl, fig4_launch,  # noqa: E402
                               radiation_table, table1_power)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))           # the reference's benchmarks/

from benchmarks import diloco_traffic as jdt  # noqa: E402
from benchmarks import fig1_isl as jfig1  # noqa: E402
from benchmarks import fig4_launch as jfig4  # noqa: E402
from benchmarks import radiation_table as jrad  # noqa: E402
from benchmarks import table1_power as jtab1  # noqa: E402

HOST = {"fig1_isl": (fig1_isl, jfig1), "fig4_launch": (fig4_launch, jfig4),
        "radiation_table": (radiation_table, jrad),
        "table1_power": (table1_power, jtab1)}
COUNTS = ("rounds_survived", "masked_pod_fraction", "straggler_pod_rounds",
          "outage_pod_rounds", "mask_transitions",
          "orbit_masked_pod_fraction", "orbit_mask_transitions",
          "round_time_s", "round_deadline_s")


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def constellation():
    """The reference's `_constellation_stats` (run once) and the port's
    from the reference's initial params, on the CPU."""
    with jax.enable_x64(False):
        want = jdt._constellation_stats()
        jcfg = jr.get_reduced_config("suncatcher-lm-100m", **tdt.MICRO)
        jparams = jr.model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tcfg = tr.get_reduced_config("suncatcher-lm-100m", **tdt.MICRO)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return want, tdt._constellation_stats("cpu", tparams)


def test_entries_cover_the_papers_benchmarks():
    assert set(ENTRIES) == {"fig1_isl", "fig2_constellation", "j2_drift",
                            "radiation_table", "fig4_launch", "table1_power",
                            "diloco_traffic", "roofline"}
    assert set(ON_DEVICE) < set(ENTRIES)
    for name in ENTRIES:
        assert (ROOT / "benchmarks" / f"{name}.py").exists(), name


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_entry_rows_and_line_equal(name):
    port, ref = HOST[name]
    (out, rows), (jout, jrows) = port.run(), ref.run()
    assert [(n, d) for n, _, d in out] == [(n, d) for n, _, d in jout]
    assert rows == jrows


def test_constellation_stats_match_the_reference(constellation):
    want, got = constellation
    assert list(got) == list(want)
    for k in COUNTS:
        assert got[k] == want[k], k
    for k in ("first_loss", "last_loss"):
        assert got[k] == pytest.approx(want[k], rel=2.0 ** -8), k
    assert got["rounds_survived"] == tdt.CONSTELLATION_ROUNDS
    assert 0 < got["masked_pod_fraction"] < 1
    assert got["last_loss"] < got["first_loss"]


def test_diloco_traffic_rows_and_lines_equal(constellation, monkeypatch):
    """`run()` of both packages with their micro DiLoCo runs replaced by
    the reference's stats: traffic rows and both derived lines equal."""
    want, _ = constellation
    monkeypatch.setattr(tdt, "_constellation_stats", lambda device: want)
    monkeypatch.setattr(jdt, "_constellation_stats", lambda: want)
    (out, rows), (jout, jrows) = tdt.run(device="cpu"), jdt.run()
    assert [(n, d) for n, _, d in out] == [(n, d) for n, _, d in jout]
    assert rows["traffic"] == jrows["traffic"]
    assert len(rows["traffic"]) == 9


def test_port_params_default_to_a_cpu_draw(constellation):
    """With no params the run draws its own from seed 0 on the CPU: the
    masks are the same (they depend on the wire bytes, not the values)."""
    want, _ = constellation
    own = tdt._constellation_stats("cpu")
    for k in COUNTS:
        assert own[k] == want[k], k
    assert np.isfinite([own["first_loss"], own["last_loss"]]).all()


def _runner(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.paper", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


def test_runner_prints_the_host_entries_as_the_reference():
    proc = _runner("--device", "cpu", "--skip",
                   "fig2_constellation,j2_drift,diloco_traffic,roofline")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    want = [(n, d) for name in ("fig1_isl", "radiation_table", "fig4_launch",
                                "table1_power")
            for n, _, d in HOST[name][1].run()[0]]
    got = [re.fullmatch(r'(\w+),[\d.]+,"(.*)"', ln).groups()
           for ln in lines[1:]]
    assert got == want


def test_runner_refuses_an_unknown_entry():
    with pytest.raises(SystemExit, match=r"unknown entries \['hlo'\]"):
        runner.main(["--device", "cpu", "--skip", "hlo"])


def test_runner_default_device_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(SystemExit, match="no CUDA device"):
        runner.main([])
