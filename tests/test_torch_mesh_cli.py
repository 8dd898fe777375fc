"""The train launcher on a device mesh (`--mesh`): "test" trains the
reduced demo LM on the one-rank (1, 1, 1) gloo mesh with fused drains;
"single" with one rank exits naming the mesh's 256 ranks and the group's
one.  Each run is a process of its own (a process group is global to its
process)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _train_cli(*args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))


def test_train_cli_mesh_test_trains_on_the_cpu():
    proc = _train_cli("--device", "cpu", "--mesh", "test", "--steps", "4",
                      "--drain-every", "2", "--seq-len", "16", "--batch",
                      "4")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh (1, 1, 1) gloo" in proc.stdout
    assert "4 steps [fused drains (K=2)]" in proc.stdout


def test_train_cli_mesh_single_with_one_rank_raises():
    proc = _train_cli("--device", "cpu", "--mesh", "single", "--steps", "2")
    assert proc.returncode != 0
    assert "has 256 ranks but the process group has 1" in proc.stderr
