"""The RG-LRU family on a gloo mesh (1, 2, 2): two sharded train steps of
the reduced recurrentgemma-2b (f32) against the unmeshed steps, within
1e-5 relative on the losses and 1e-5 of the largest magnitude on every
state leaf (tests/_torch_mesh_worker.py, job "family"). The scan (B4)
runs on each rank's channels; the windowed MQA block's 4 query heads
shard over "model" while its one KV head is replicated, so each rank
reads the KV head of its own queries and the KV gradients are partial
sums over the model ranks."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_sharded_steps_within_tolerance(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
         "family", "4", str(tmp_path), "recurrentgemma-2b"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), proc.stderr[-6000:]
    with open(tmp_path / "result.json") as f:
        r = json.load(f)
    for a, b in zip(r["loss"], r["loss_mesh"]):
        assert abs(a - b) <= 1e-5 * abs(a), (a, b)
    assert r["max_abs_diff"] <= 1e-5 * r["max_abs"], r
