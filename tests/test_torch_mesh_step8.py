"""The sharded train step, fused K-step block and DiLoCo round on eight
gloo ranks at (2, 2, 2) against their unmeshed forms (the reduced demo
LM at f32 compute; tests/_torch_mesh_worker.py, job "step").  The ranks
add partial sums in another order than one device does (the batch over
"data", the heads and the MLP over "model", a microbatch of each rank's
own rows), so the results are held to a tolerance: losses within 1e-5
relative, every param and state leaf within 1e-5 of the largest
magnitude of its tree after two steps (one round).  One rank, bitwise:
tests/test_torch_mesh_step.py."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("step8")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
         "step", "8", str(out)],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), proc.stderr[-6000:]
    with open(out / "result.json") as f:
        return json.load(f)


@pytest.mark.parametrize("what", ["step", "fused", "round"])
def test_eight_rank_mesh_within_tolerance(result, what):
    r = result[what]
    for a, b in zip(r["loss"], r["loss_mesh"]):
        assert abs(a - b) <= 1e-5 * abs(a), (a, b)
    assert r["max_abs_diff"] <= 1e-5 * r["max_abs"], r


def test_eight_rank_fused_block_is_the_sharded_steps(result):
    """The fused block and the per-step loop on the same mesh run the
    same sharded arithmetic: bitwise."""
    assert result["fused_equals_step_sharded"]
