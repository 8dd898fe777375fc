"""Smoke-run every port example (`examples/torch_port/*.py`) on the CPU at
the reference examples' smoke flags (tests/test_examples.py) plus
`--device cpu` for the four that run on a device (the design studio is
host numpy and takes no flags), each in a process of its own (all started together): exit
0 and the sentinel line.  The port's examples are the reference's five,
name for name, and the design studio prints what the reference's prints,
line for line (host numpy float64 in both; the reference under
jax_enable_x64)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_examples import SMOKE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "examples" / "torch_port"
# what the examples that train or serve print of their kernels' launches
LAUNCHES = {"quickstart.py": "flash-attention kernel launches 0 (on cpu)",
            "train_100m.py": "flash-attention kernel launches 0 (on cpu)",
            "serve_batch.py": "decode-attention kernel launches: dense 0 "
                              "(on cpu)"}
# the examples that run on a device and so take --device
ON_DEVICE = {"quickstart.py", "serve_batch.py", "train_100m.py",
             "formation_flight.py"}


def _start(script, *args, jax=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, str(script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def runs():
    """{name: (exit code, stdout, stderr)} of the five port examples and
    of the reference's constellation_design, run side by side."""
    procs = {name: _start(PORT / name, *args,
                          *(("--device", "cpu") if name in ON_DEVICE else ()))
             for name, (args, _) in SMOKE.items()}
    procs["reference constellation_design.py"] = _start(
        ROOT / "examples" / "constellation_design.py", jax=True)
    out = {}
    try:
        for name, p in procs.items():
            o, e = p.communicate(timeout=600)
            out[name] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_port_examples_are_the_references():
    on_disk = {p.name for p in PORT.glob("*.py")}
    assert on_disk == {p.name for p in (ROOT / "examples").glob("*.py")}
    assert on_disk == set(SMOKE)


@pytest.mark.parametrize("script", sorted(SMOKE), ids=lambda s: s[:-3])
def test_port_example_runs(runs, script):
    rc, out, err = runs[script]
    assert rc == 0, out[-2000:] + err[-2000:]
    assert SMOKE[script][1] in out, out[-2000:]
    if script in LAUNCHES:
        assert LAUNCHES[script] in out, out[-2000:]


def test_constellation_design_prints_what_the_reference_prints(runs):
    rc, want, err = runs["reference constellation_design.py"]
    assert rc == 0, err[-2000:]
    got = runs["constellation_design.py"][1]
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) == 17
