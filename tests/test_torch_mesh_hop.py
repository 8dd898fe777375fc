"""The DiLoCo pod hop over a process group: 8 gloo ranks at (2, 2, 2),
the reference worker's reduced demo LM (tests/_wire_workers.py;
tests/_torch_mesh_worker.py, job "hop").  `_wire_shard_hop` ==
`_wire_sim_hop` bitwise for int8 and top-k, pod 1 masked in round 1,
error feedback carried into round 2 (asserted in the worker); two
all-gathers of the compressed payload per wire leaf, of its dtypes only;
and the rounds equal the reference's `_wire_sim_hop` on
`fmt.simulated()` from the same state, through numpy."""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import diloco as jdl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_mesh_worker.py"


def _paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in kp): leaf for kp, leaf in flat}


@pytest.fixture(scope="module")
def hop(tmp_path_factory):
    out = tmp_path_factory.mktemp("hop")
    proc = subprocess.run(
        [sys.executable, str(WORKER), "hop", "8", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), proc.stderr[-6000:]
    with open(out / "result.json") as f:
        result = json.load(f)
    return result, dict(np.load(out / "hop.npz"))


def _nest(flat: dict, prefix: str) -> dict:
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(arr)
    return out


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_wire_shard_hop_payload_all_gathers(hop, method):
    """Two all-gathers per wire leaf, every round, carrying only the
    compressed payload's dtypes."""
    result, _ = hop
    r = result[method]
    for coll in r["collectives"]:
        assert coll["counts"] == {"all-gather": 2 * r["n_leaves"]}
        dts = set(coll["bytes_by_dtype"]["all-gather"])
        assert dts == ({"s8", "f32"} if method == "int8"
                       else {"f32", "s32"})


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_wire_shard_hop_equals_the_reference_simulated_hop(hop, method):
    """The 8-rank hop's rounds (bitwise the port's simulated hop inside
    the worker) equal the reference's `_wire_sim_hop` on
    `fmt.simulated()` from the same state, through numpy."""
    _, arrays = hop
    d0 = _nest(arrays, f"{method}/d0")
    dcfg = jdl.DiLoCoConfig(n_pods=2)
    rcfg = jreg.get_reduced_config(
        "suncatcher-lm-100m", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=1, d_ff=64, vocab_size=256)
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty((2, 2, 2)))
    fmt = jcomp.wire_format_for(
        d0["global_params"], jsh.param_specs(rcfg, fsdp=True,
                                             multi_pod=True),
        mesh, 2, method=method).simulated()
    d0["step"] = jnp.asarray(d0["step"])
    state = d0
    for r, mask in enumerate(([1.0, 0.0], [1.0, 1.0])):
        state = jdl.outer_step(state, dcfg, pod_mask=jnp.asarray(mask),
                               wire=fmt)
        for key in ("global_params", "outer_m", "pod_ef"):
            want = _nest(arrays, f"{method}/round{r + 1}/{key}")
            got = _paths(state[key])
            for k, v in _paths(want).items():
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(v), err_msg=k)
