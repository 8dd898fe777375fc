"""The port on a device mesh, against the JAX package where the reference
can still say what is right.

  - Spec parity: for all 11 archs at full width, on the (16, 16) and
    (2, 16, 16) production meshes, FSDP on and off, the port's sanitized
    param specs equal the reference's `sanitize_specs(param_specs(...))`
    leaf by leaf; so do the cache specs, the DiLoCo state specs, the wire
    lanes and `outer_wire_bytes(..., wire=fmt)`.  The reference needs no
    512 devices for this: a stand-in mesh with `axis_names` and `devices`
    is all its `sanitize_specs` and `wire_format_for` read.
  - Collective accounting: the port's counter on known collectives of a
    fake group equals the reference's `collective_bytes` on the
    equivalent HLO lines.
Process groups are global to a process, so the mesh work runs in
subprocess workers (tests/_torch_mesh_worker.py).  The pod hop on 8
ranks: tests/test_torch_mesh_hop.py; the launcher's --mesh:
tests/test_torch_mesh_cli.py; the sharded steps:
tests/test_torch_mesh_step.py and tests/test_torch_mesh_step8.py."""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import diloco as jdl  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import diloco as tdl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_mesh_worker.py"
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


def _ref_mesh(kind):
    names, shape = MESHES[kind]
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _sizes(kind):
    names, shape = MESHES[kind]
    return dict(zip(names, shape))


def _paths(tree, is_leaf=None) -> dict:
    """"a/b/0" path -> leaf of a JAX pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    out = {}
    for kp, leaf in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        out["/".join(parts)] = leaf
    return out


def _port_paths(tree, prefix="") -> dict:
    """The same for the port's trees of dicts and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tuple) and tree and not isinstance(
            tree[0], (str, type(None))) and not _is_spec(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _is_spec(t) -> bool:
    return all(e is None or isinstance(e, str) or (
        isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t)


def _is_p(x):
    return x is None or isinstance(x, P)


def _spec_dict(tree):
    return {k: tuple(v) for k, v in _paths(tree, is_leaf=_is_p).items()}


@lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jreg.get_config(arch)
    fns = jreg.model_fns(cfg)
    return cfg, jax.eval_shape(lambda: fns.init(jax.random.PRNGKey(0), cfg))


def _port_params(arch):
    cfg = treg.get_config(arch)
    return cfg, tsh.param_shapes(cfg)


def _same_shapes(ref_tree, port_tree):
    ref = {k: tuple(v.shape) for k, v in _paths(ref_tree).items()}
    port = {k: tuple(v.shape) for k, v in _port_paths(port_tree).items()}
    assert ref == port


CASES = [(a, m, f) for a in treg.ARCH_IDS for m in MESHES
         for f in (True, False)]


@pytest.mark.parametrize("arch,mesh,fsdp", CASES,
                         ids=[f"{a}-{m}-{'fsdp' if f else 'tp'}"
                              for a, m, f in CASES])
def test_param_specs_equal_the_reference(arch, mesh, fsdp):
    rcfg, rparams = _ref_params(arch)
    tcfg, tparams = _port_params(arch)
    _same_shapes(rparams, tparams)
    multi = mesh == "multi"
    ref = jsh.sanitize_specs(jsh.param_specs(rcfg, fsdp=fsdp,
                                             multi_pod=multi),
                             rparams, _ref_mesh(mesh))
    port = tsh.sanitize_specs(tsh.param_specs(tcfg, fsdp=fsdp,
                                              multi_pod=multi),
                              tparams, _sizes(mesh))
    assert _spec_dict(ref) == _port_paths(port)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_cache_and_diloco_specs_equal_the_reference(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    rcfg, rparams = _ref_params(arch)
    tcfg, tparams = _port_params(arch)
    rfns, tfns = jreg.model_fns(rcfg), treg.model_fns(tcfg)
    for mesh in MESHES:
        multi = mesh == "multi"
        # the serving cache of decode_32k
        rc = jax.eval_shape(lambda: rfns.init_cache(rcfg, 128, 32768))
        with FakeTensorMode():
            tc = tfns.init_cache(tcfg, 128, 32768, device="cpu")
        _same_shapes(rc, tc)
        ref = jsh.sanitize_specs(jsh.cache_specs(rcfg, multi_pod=multi), rc,
                                 _ref_mesh(mesh))
        port = tsh.sanitize_specs(tsh.cache_specs(tcfg, multi_pod=multi),
                                  tc, _sizes(mesh))
        assert _spec_dict(ref) == _port_paths(port)
        # the DiLoCo state, compressed, with screens
        dcfg = jdl.DiLoCoConfig(n_pods=2)
        rd = jax.eval_shape(lambda: jdl.diloco_init(
            jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), rparams),
            dcfg, compress="int8", screen_window=8))
        pspecs = jsh.param_specs(rcfg, multi_pod=multi)
        ref = jsh.sanitize_specs(
            jsh.diloco_specs(pspecs, compress=True, screen=True), rd,
            _ref_mesh(mesh))
        port = tsh.sanitize_specs(
            tsh.diloco_specs(tsh.param_specs(tcfg, multi_pod=multi),
                             compress=True, screen=True),
            _diloco_shapes(tparams, 2, 8), _sizes(mesh))
        assert _spec_dict(ref) == _port_paths(port)


def _diloco_shapes(pshapes, n, window):
    SDS = tsh.SDS

    def pod(t, dtype=None):
        return tsh.tree_map(lambda s: SDS((n,) + tuple(s.shape),
                                          dtype or s.dtype), t)
    return {"global_params": pshapes,
            "outer_m": tsh.tree_map(lambda s: SDS(s.shape, torch.float32),
                                    pshapes),
            "pod_params": pod(pshapes),
            "pod_opt": {"m": pod(pshapes, torch.float32),
                        "v": pod(pshapes, torch.float32),
                        "step": SDS((n,), torch.int32)},
            "step": SDS((), torch.int32),
            "pod_ef": pod(pshapes, torch.float32),
            "screen": {"loss": SDS((n, window), torch.float32),
                       "gnorm": SDS((n, window), torch.float32),
                       "count": SDS((n,), torch.int32)}}


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_wire_lanes_and_outer_wire_bytes_equal_the_reference(arch):
    rcfg, rparams = _ref_params(arch)
    tcfg, tparams = _port_params(arch)
    for mesh in MESHES:
        multi = mesh == "multi"
        for method in ("int8", "topk"):
            rf = jcomp.wire_format_for(
                rparams, jsh.param_specs(rcfg, multi_pod=multi),
                _ref_mesh(mesh), 2, method=method)
            tf = tcomp.wire_format_for(
                tparams, tsh.param_specs(tcfg, multi_pod=multi),
                _sizes(mesh), 2, method=method)
            ref = {k: (tuple(v.counts), tuple(v.spec)) for k, v in _paths(
                rf.layout, is_leaf=jcomp.is_wire_leaf).items()}
            port = {k: (tuple(v.counts), tuple(v.spec)) for k, v in
                    _port_paths(tf.layout).items()}
            assert ref == port
            assert tdl.outer_wire_bytes(tparams, wire=tf) == \
                jdl.outer_wire_bytes(rparams, wire=rf)
        assert tdl.outer_wire_bytes(tparams) == jdl.outer_wire_bytes(rparams)


def test_demo_lm_outer_wire_bytes():
    tcfg, tparams = _port_params("suncatcher-lm-100m")
    fmt = tcomp.wire_format_for(tparams, tsh.param_specs(tcfg,
                                                         multi_pod=True),
                                _sizes("multi"), 2, method="int8")
    assert tdl.outer_wire_bytes(tparams, wire=fmt) == 102_255_660
    assert tdl.outer_wire_bytes(tparams) == 402_729_984
    # a stand-in mesh is not a DeviceMesh: the format is the simulation
    assert fmt.mesh is None and fmt.simulated() == fmt


def test_pod_data_batch_shards_pod_major():
    """("pod", "data") on one dim is Shard(dim) on both mesh dims, split
    pod first: the reference's PartitionSpec order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 4, 4))
    assert tsh.placements_for((("pod", "data"), None), (16, 3), mesh) == \
        [Shard(0), Shard(0), Replicate()]
    # the rank at pod p, data d holds rows (p * 4 + d) * 2 ... + 2
    x = torch.arange(16).reshape(16, 1)
    for p in range(2):
        for d in range(4):
            local = x.chunk(2, dim=0)[p].chunk(4, dim=0)[d]
            assert local.reshape(-1).tolist() == [(p * 4 + d) * 2,
                                                  (p * 4 + d) * 2 + 1]
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements_for((("data", "pod"),), (16,), mesh)
    # an axis that does not divide is dropped (the reference's rule)
    assert tsh.sanitize_spec(("model", "data"), (12, 32),
                             {"data": 16, "model": 16}) == (None, "data")


def _worker(job, n, tmp_path, *args, timeout=600):
    proc = subprocess.run(
        [sys.executable, str(WORKER), job, str(n), str(tmp_path), *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and \
        proc.stdout.strip().endswith("MESH-WORKER-OK"), \
        proc.stdout[-3000:] + proc.stderr[-6000:]
    with open(tmp_path / "result.json") as f:
        return json.load(f)


def _hlo_line(kind, shape_str):
    return f"  %x = {shape_str} {kind}(%y), replica_groups={{}}\n"


def test_collective_counter_equals_the_reference_on_hlo(tmp_path):
    """The worker's known collectives on a fake group of 4 ranks, and
    the same collectives as the reference's post-SPMD HLO lines (result
    shapes per device)."""
    from repro.analysis.hlo import collective_bytes
    port = _worker("collect", 4, tmp_path, timeout=240)
    hlo = "".join([
        _hlo_line("all-gather", "s8[12,256]{1,0}"),
        _hlo_line("all-gather", "f32[12,1]{1,0}"),
        _hlo_line("all-reduce", "f32[10,7]{1,0}"),
        _hlo_line("all-reduce", "bf16[4,4]{1,0}"),
        _hlo_line("reduce-scatter", "f32[6]{0}"),
        _hlo_line("all-to-all", "s32[8,3]{1,0}"),
    ])
    assert port == collective_bytes(hlo)
