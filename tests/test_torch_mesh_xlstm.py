"""The xLSTM family on a gloo mesh (1, 2, 2): two sharded train steps of
the reduced xlstm-350m (f32) against the unmeshed steps, within 1e-5
relative on the losses and 1e-5 of the largest magnitude on every state
leaf (tests/_torch_mesh_worker.py, job "family"). The sLSTM and mLSTM
cores run under `local_map` on each rank's rows: the sLSTM's recurrent
weights get partial gradients over the batch ranks."""
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
         "family", "4", str(tmp_path), "xlstm-350m"],
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
