"""The port's orbit entries (`repro_torch.paper.fig2_constellation`,
`j2_drift`) against the reference's `benchmarks/` entries, in float64.

The reference's entries turn jax_enable_x64 on when imported, so they
run in a subprocess of their own (a global flip would leak into the other
tests of a worker), while the port's run here on the CPU.

Limits, each with its reason:
  - derived lines equal (their figures are rounded to 0-2 decimals);
  - Fig. 2: the Hill states of one orbit within 1e-5 m and 1e-8 m/s and
    the neighbour distances within 1e-5 m, as
    tests/test_torch_orbital.py holds `simulate_cluster` to the jitted
    reference (rounding over ~1,200 steps at 7e6 m); the sample times
    equal;
  - J2 drift: each kappa's rate within 1e-6 relative (least-squares
    slopes of positions that agree to 1e-7 m), the same kappas and the
    same best kappa.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.paper import fig2_constellation, j2_drift  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = """
import json, sys
import numpy as np
from benchmarks import fig2_constellation, j2_drift
out2, arr = fig2_constellation.run()
outj, rates = j2_drift.run()
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in arr.items()})
print(json.dumps({"lines": [[n, d] for n, _, d in out2 + outj],
                  "rates": [[k, v] for k, v in rates.items()]}))
"""


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """(reference, port) results: the reference's subprocess runs while
    the port's entries run here."""
    npz = tmp_path_factory.mktemp("orbit") / "fig2.npz"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(npz)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        port = {"fig2": fig2_constellation.run(device="cpu"),
                "j2": j2_drift.run(device="cpu")}
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    ref["arrays"] = dict(np.load(npz))
    return ref, port


def test_derived_lines_equal(entries):
    ref, port = entries
    got = [[n, d] for n, _, d in port["fig2"][0] + port["j2"][0]]
    assert got == ref["lines"]


def test_fig2_arrays_match(entries):
    ref, port = entries
    arr = ref["arrays"]
    got = {k: v.cpu().numpy() for k, v in port["fig2"][1].items()}
    assert set(got) == set(arr) == {"ts", "hill", "direct", "diag"}
    np.testing.assert_array_equal(got["ts"], arr["ts"])
    assert got["hill"].shape == arr["hill"].shape == (121, 81, 6)
    np.testing.assert_allclose(got["hill"][..., :3], arr["hill"][..., :3],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["hill"][..., 3:], arr["hill"][..., 3:],
                               rtol=0, atol=1e-8)
    for k in ("direct", "diag"):
        np.testing.assert_allclose(got[k], arr[k], rtol=0, atol=1e-5)


def test_j2_rates_match(entries):
    ref, port = entries
    want = dict((float(k), v) for k, v in ref["rates"])
    got = port["j2"][1]
    assert list(got) == list(want) == [1.0, 0.999]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert min(got, key=got.get) == min(want, key=want.get) == 0.999
    assert got[0.999] < 0.5 * got[1.0]
