"""The sharded train step, fused K-step block and DiLoCo round on a
one-rank gloo mesh (1, 1, 1) against their unmeshed forms, bitwise: the
reduced demo LM at f32 compute, two steps at two microbatches, a K = 2
fused block, one int8 round of 2 pods x H 2 under supervision with
screens (tests/_torch_mesh_worker.py, job "step").  On one rank every
DTensor redistribution is the identity and no op is decomposed
differently, so nothing here is held to a tolerance.  Eight ranks:
tests/test_torch_mesh_step8.py."""
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
    out = tmp_path_factory.mktemp("step1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
         "step", "1", str(out), "bitwise"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), proc.stderr[-6000:]
    with open(out / "result.json") as f:
        return json.load(f)


@pytest.mark.parametrize("what", ["step", "fused", "round"])
def test_one_rank_mesh_is_bitwise_the_unmeshed_form(result, what):
    r = result[what]
    assert r["equal"], r
    assert r["loss"] == r["loss_mesh"]


def test_one_rank_round_metrics_and_fused_block_agree(result):
    assert result["round"]["metrics_equal"]
    # the fused block's two steps are the per-step loop's two steps
    assert result["fused_equals_step_sharded"]
