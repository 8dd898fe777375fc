"""Shared by tests/test_torch_seqpar_*.py: the reduced minicpm-2b (6
heads, head_dim 12, f32) in both packages, its reference params and
train state as npz inputs of the mesh worker's "seqpar" job
(tests/_torch_mesh_worker.py), and the worker's run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from repro.models import registry as jreg

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_mesh_worker.py"
ARCH = "minicpm-2b"


def jax_model():
    cfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    return cfg, jreg.model_fns(cfg)


def flat(tree, prefix: str) -> dict:
    """"prefix/a/b" -> numpy leaf of a JAX pytree of dicts."""
    return {prefix + "/" + "/".join(str(p.key) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_worker(tmp_path, world: int, kind: str, mesh: str, inputs: dict):
    """The worker's seqpar job on `world` gloo ranks: (result.json,
    seqpar.npz)."""
    np.savez(tmp_path / "in.npz", **inputs)
    proc = subprocess.run(
        [sys.executable, str(WORKER), "seqpar", str(world), str(tmp_path),
         kind, mesh, str(tmp_path / "in.npz")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), \
        proc.stdout[-3000:] + proc.stderr[-6000:]
    with open(tmp_path / "result.json") as f:
        result = json.load(f)
    return result, dict(np.load(tmp_path / "seqpar.npz"))


def close(got, want, tol=1e-5):
    """Within `tol` of the reference's largest magnitude."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err,
                                                    float(np.abs(want).max()))
