"""The port's DiLoCo (`repro_torch.train.diloco`) and DiLoCoSupervisor
against the JAX package's, and the port's own DiLoCo invariants.

The shape is the reference's `_micro_diloco_setup` (tests/test_training.py:
2 layers, d 32, 2/1 heads, d_ff 64, vocab 256, seq 8, batch 2; 2 pods,
H 4) at f32 compute; the port takes the reference's initial params
through `params_from_jax`, and both packages draw the same token stream.
Tolerances:
  - `diloco_init`: bitwise.
  - `outer_step` on the same d_state: the EF residuals (so what was sent)
    bitwise; global params, outer momentum and pod replicas at rtol 1e-6.
  - rounds without compression: losses, grad norms and every float leaf
    of the state after 2 rounds at rtol 1e-5, atol 1e-4 (as
    tests/test_torch_training.py's eight steps).
  - compressed rounds: the same, plus one quantization step for int8.
    The inner steps differ by f32 rounding, so an element whose EF
    target sits at a rounding boundary of its int8 block may round to
    the neighbouring level in one package: the sent value, and through
    the outer update the state, then differ by up to one quantum q =
    block absmax / 127.  Each float leaf is held within 1e-5 * |ref| +
    1e-4 + q_max, with q_max = 2 * max |EF| of the reference (an int8
    residual is at most half a quantum), and the share of elements off
    by more than 1e-6 is at most 1% (measured on this config: 0.010%
    after round 1, 0.051% after round 2).  Top-k is held to the
    uncompressed tolerance (no selection flipped here; 0.004% / 0.007%
    of elements off by more than 1e-6).
  - the supervisor: stats bitwise, and each round's mask, stragglers,
    outages and thresholds; its mean loss at rtol 1e-5.

The reference runs with jax's default 32-bit types (other test modules
turn on jax_enable_x64 process-wide)."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isl as jisl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import diloco as jdl  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import DataConfig as JDataConfig  # noqa: E402
from repro.train import DiLoCoSupervisor as JSupervisor  # noqa: E402
from repro.train import FTConfig as JFTConfig  # noqa: E402
from repro.train import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.data import pod_step_grid  # noqa: E402
from repro_torch.core import isl as tisl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.train import (AdamWConfig, DataConfig,  # noqa: E402
                               DiLoCoConfig, DiLoCoSupervisor, FTConfig,
                               SyntheticLM, TrainConfig, diloco_init,
                               isl_bytes_per_step, make_diloco_round,
                               make_inner_steps, outer_step,
                               outer_wire_bytes)
from repro_torch.train.tree import tree_map, tree_paths  # noqa: E402

torch.set_num_threads(1)

ARCH = "suncatcher-lm-100m"
ROOT = Path(__file__).resolve().parents[1]
MICRO = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab_size=256)
THR = (3.0, 10.0)


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def m():
    """Both packages' micro DiLoCo setup, the port's params carried over
    from the reference's."""
    with jax.enable_x64(False):
        jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32",
                                       **MICRO)
        jfns = jreg.model_fns(jcfg)
        jparams = jfns.init(jax.random.PRNGKey(0), jcfg)
        jdata = JSyntheticLM(JDataConfig(vocab_size=256, seq_len=8,
                                         global_batch=2))
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32", **MICRO)
    tfns = treg.model_fns(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    return SimpleNamespace(
        jcfg=jcfg, jfns=jfns, jparams=jparams, jdata=jdata,
        jtrain=JTrainConfig(adamw=JAdamW(lr=3e-3), warmup_steps=2,
                            total_steps=100),
        jdcfg=jdl.DiLoCoConfig(n_pods=2, inner_steps=4),
        tcfg=tcfg, tfns=tfns, tparams=tparams,
        tdata=SyntheticLM(DataConfig(vocab_size=256, seq_len=8,
                                     global_batch=2), "cpu"),
        ttrain=TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                           total_steps=100),
        dcfg=DiLoCoConfig(n_pods=2, inner_steps=4))


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.detach().numpy() for k, v in tree_paths(tree).items()}


def _rebuild(tree, jflat, prefix=""):
    """The port tree `tree` with every leaf replaced by the reference
    leaf of the same path."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, jflat, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(jflat[prefix]))


def _assert_close(got: dict, want: dict, rtol, atol, keys=None, slack=0.0):
    """Every float leaf within rtol/atol (+ slack); int leaves equal.
    Returns the share of float elements off by more than 1e-6."""
    off = total = 0
    for name, w in want.items():
        if keys is not None and not name.startswith(keys):
            continue
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.floating):
            d = np.abs(g.astype(np.float64) - w)
            lim = rtol * np.abs(w) + atol + slack
            assert (d <= lim).all(), (name, d.max())
            off += int((d > 1e-6).sum())
            total += d.size
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return off / max(total, 1)


def _assert_trees_equal(a, b, keys=None):
    pa, pb = tree_paths(a), tree_paths(b)
    if keys is not None:
        pa = {k: v for k, v in pa.items() if k.startswith(keys)}
        pb = {k: v for k, v in pb.items() if k.startswith(keys)}
    assert list(pa) == list(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        assert torch.equal(pa[k], pb[k]), k


def _rounds(m, compress, n_rounds=2, **kw):
    """n_rounds of the supervised round with on-device data and screens
    in both packages: (jax d_state, port d_state, per-round metrics)."""
    jr = jdl.make_diloco_round(m.jcfg, m.jfns, m.jtrain, m.jdcfg,
                               compress=compress, data=m.jdata,
                               screen_window=16, supervise=True,
                               donate=False, **kw)
    tr = make_diloco_round(m.tcfg, m.tfns, m.ttrain, m.dcfg,
                           compress=compress, data=m.tdata,
                           screen_window=16, supervise=True)
    jd = jdl.diloco_init(m.jparams, m.jdcfg, compress=compress,
                         screen_window=16)
    td = diloco_init(m.tparams, m.dcfg, compress=compress, screen_window=16)
    out = []
    for r in range(n_rounds):
        grid = pod_step_grid(r, 2, 4)
        jd, jm = jr(jd, jnp.asarray(grid), jnp.ones(2),
                    jnp.asarray(THR, jnp.float32))
        td, tm = tr(td, torch.as_tensor(grid), torch.ones(2),
                    torch.tensor(THR))
        out.append((jm, tm))
    return jd, td, out


# ------------------------------------------------- parity with the JAX ----

@pytest.mark.parametrize("compress,window", [(None, 0), ("int8", 16),
                                             ("topk", 0)])
def test_diloco_init_matches_jax(m, compress, window):
    jd = jdl.diloco_init(m.jparams, m.jdcfg, compress=compress,
                         screen_window=window)
    td = diloco_init(m.tparams, m.dcfg, compress=compress,
                     screen_window=window)
    jf, tf = _jflat(jd), _tflat(td)
    assert set(tf) == set(jf)
    for k, want in jf.items():
        assert tf[k].dtype == want.dtype and tf[k].shape == want.shape, k
        assert tf[k].tobytes() == want.tobytes(), k


@pytest.mark.parametrize("mask", [(1.0, 1.0), (1.0, 0.0), (0.0, 0.0)])
@pytest.mark.parametrize("compress", [None, "int8", "topk"])
def test_outer_step_matches_jax(m, compress, mask):
    """The same d_state (pod replicas moved off the globals by seeded
    noise, non-zero outer momentum and EF; a masked pod NaN-poisoned):
    EF bitwise, the rest at rtol 1e-6."""
    jd = jdl.diloco_init(m.jparams, m.jdcfg, compress=compress)
    rng = np.random.default_rng(4)
    jf = {}
    for k, v in _jflat(jd).items():
        v = np.array(v)
        if k.startswith("pod_params"):
            v = v + 1e-2 * rng.standard_normal(v.shape).astype(np.float32)
            if mask[1] == 0.0:
                v[1] = np.nan
        elif k.startswith(("outer_m", "pod_ef")):
            v = 1e-3 * rng.standard_normal(v.shape).astype(np.float32)
        jf[k] = v
    jd = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jd),
        [jnp.asarray(jf["/".join(str(p.key) for p in path)])
         for path, _ in jax.tree_util.tree_flatten_with_path(jd)[0]])
    td = _rebuild(diloco_init(m.tparams, m.dcfg, compress=compress), jf, "")
    jmask = jnp.asarray(mask, jnp.float32)
    want = _jflat(jdl.outer_step(jd, m.jdcfg, pod_mask=jmask,
                                 compress=compress))
    got = _tflat(outer_step(td, m.dcfg, pod_mask=torch.tensor(mask),
                            compress=compress))
    for k in want:
        if k.startswith("pod_ef"):
            assert got[k].tobytes() == want[k].tobytes(), k
    _assert_close(got, want, 1e-6, 0.0,
                  keys=("global_params", "outer_m", "pod_params"))
    for k, v in got.items():
        if k.startswith("global_params"):
            assert np.isfinite(v).all(), k


def test_rounds_without_compression_match_jax(m):
    jd, td, out = _rounds(m, None)
    for jm, tm in out:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        for k in ("suspect", "pod_bad", "outer_ok"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    _assert_close(_tflat(td), _jflat(jd), 1e-5, 1e-4)


@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_compressed_rounds_match_jax_within_one_quantum(m, compress):
    jd, td, out = _rounds(m, compress)
    for jm, tm in out:
        np.testing.assert_allclose(tm["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5)
    want = _jflat(jd)
    q_max = 2 * max(np.abs(v).max() for k, v in want.items()
                    if k.startswith("pod_ef"))
    share = _assert_close(_tflat(td), want, 1e-5, 1e-4,
                          slack=q_max if compress == "int8" else 0.0)
    assert share <= 1e-2, share


def _liveness(pkg, m):
    return pkg.ConstellationLinkModel(cfg=pkg.LivenessConfig(
        n_pods=2, outer_wire_bytes=outer_wire_bytes(m.tparams),
        outage_rate_multiplier=30.0))


def _poison(tree_map_fn, d, nan):
    return {**d, "pod_params": tree_map_fn(
        lambda x: x.at[1].set(nan) if hasattr(x, "at")
        else torch.cat([x[:1], torch.full_like(x[1:], nan)]),
        d["pod_params"])}


@pytest.fixture(scope="module")
def sup_runs(m, tmp_path_factory):
    """Supervisor runs of 6 rounds in both packages under the
    constellation's masks: clean, a whole-round rollback forced at round
    3, and pod 1 NaN-poisoned from the start."""
    with jax.enable_x64(False):
        jr = jdl.make_diloco_round(m.jcfg, m.jfns, m.jtrain, m.jdcfg,
                                   data=m.jdata, screen_window=16,
                                   supervise=True)
        jlive = _liveness(jisl, m)
        runs = {}
        for name, forced in (("clean", None), ("forced", [3]),
                             ("poisoned", None)):
            tmp = tmp_path_factory.mktemp(name)
            jd = jdl.diloco_init(m.jparams, m.jdcfg, screen_window=16)
            td = diloco_init(m.tparams, m.dcfg, screen_window=16)
            if name == "poisoned":
                jd = _poison(jax.tree.map, jd, jnp.nan)
                td = _poison(tree_map, td, float("nan"))
            js = JSupervisor(jr, jd, m.jdcfg, JFTConfig(
                checkpoint_dirs=(str(tmp / "ja"), str(tmp / "jb")),
                checkpoint_every=8), liveness=jlive)
            ts = DiLoCoSupervisor(
                make_diloco_round(m.tcfg, m.tfns, m.ttrain, m.dcfg,
                                  data=m.tdata, screen_window=16,
                                  supervise=True),
                td, m.dcfg, FTConfig(
                    checkpoint_dirs=(str(tmp / "ta"), str(tmp / "tb")),
                    checkpoint_every=8), liveness=_liveness(tisl, m))
            js.run(6, forced_rollback_at=forced)
            ts.run(6, forced_rollback_at=forced)
            runs[name] = (js, ts, tmp)
    return runs


@pytest.mark.parametrize("name", ["clean", "forced", "poisoned"])
def test_supervisor_stats_and_history_match_jax(sup_runs, name):
    js, ts, _ = sup_runs[name]
    assert ts.stats == js.stats
    assert len(ts.history) == len(js.history) == 6
    for th, jh in zip(ts.history, js.history):
        assert th["round"] == jh["round"]
        assert th["alive"].tobytes() == np.asarray(jh["alive"]).tobytes()
        assert (th["straggler"], th["outage"], th["thresholds"]) == \
            (jh["straggler"], jh["outage"], jh["thresholds"])
        assert th["loss"] == pytest.approx(jh["loss"], rel=1e-5)
    assert ts.stats["masked_pod_rounds"] > 0      # the masks moved
    if name == "forced":
        assert ts.stats["rollbacks"] == 1 and ts.stats["drains"] == 8
        assert ts.stats["replay_verified_rounds"] >= 1
        assert ts.stats["replay_mismatches"] == 0
    if name == "poisoned":
        assert ts.stats["pod_rollbacks"] == 1 and ts.stats["rollbacks"] == 0
        assert all(np.isfinite(h["loss"]) for h in ts.history)


def test_wire_bytes_and_isl_accounting_match_jax(m):
    for compress in (None, "int8", "topk"):
        assert outer_wire_bytes(m.tparams, compress) == \
            jdl.outer_wire_bytes(m.jparams, compress)
        for n_params in (10**6, 10**9):
            assert isl_bytes_per_step(n_params, 50, compress) == \
                jdl.isl_bytes_per_step(n_params, 50, compress)


# ------------------------------------------- the recurrent families ----

CARRY_ARCHS = {"recurrentgemma-2b": trg, "xlstm-350m": tx}


def _recurrent(arch, dtype=None):
    """Both packages' reduced `arch` (the reference test's setup: init
    from PRNGKey(0), lr 3e-3, 2 pods x H 2, seq 8, batch 2), the port's
    params carried over from the reference's, and each package's first
    round's step grid of batches."""
    over = {} if dtype is None else {"compute_dtype": dtype}
    with jax.enable_x64(False):
        jcfg = jreg.get_reduced_config(arch, **over)
        jfns = jreg.model_fns(jcfg)
        jparams = jfns.init(jax.random.PRNGKey(0), jcfg)
        jdata = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size,
                                         seq_len=8, global_batch=2))
        jbatches = jdata.batch_block(np.arange(4).reshape(2, 2))
    tcfg = treg.get_reduced_config(arch, **over)
    tparams = CARRY_ARCHS[arch].params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tbatches = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=8,
                                      global_batch=2), "cpu").batch_block(
        np.arange(4).reshape(2, 2))
    return SimpleNamespace(
        jcfg=jcfg, jfns=jfns, jparams=jparams, jbatches=jbatches,
        tcfg=tcfg, tfns=treg.model_fns(tcfg), tparams=tparams,
        tbatches=tbatches,
        jtrain=JTrainConfig(adamw=JAdamW(lr=3e-3), warmup_steps=2,
                            total_steps=100),
        ttrain=TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                           total_steps=100),
        jdcfg=jdl.DiLoCoConfig(n_pods=2, inner_steps=2),
        dcfg=DiLoCoConfig(n_pods=2, inner_steps=2))


@pytest.mark.parametrize("arch", list(CARRY_ARCHS))
def test_recurrent_fused_diloco_round_bit_identical(arch):
    """The port's counterpart of tests/test_decode_state.py::
    test_recurrent_fused_diloco_round_bit_identical: the fused round
    runs the recurrent families (the RG-LRU scan and its backward, the
    sLSTM loop and the mLSTM) and equals make_inner_steps + outer_step
    bitwise, at the reduced config's own compute dtype."""
    r = _recurrent(arch)
    mask = torch.ones(2)
    inner = make_inner_steps(r.tcfg, r.tfns, r.ttrain, r.dcfg)
    ref, _ = inner(diloco_init(r.tparams, r.dcfg), r.tbatches)
    ref = outer_step(ref, r.dcfg, pod_mask=mask)
    rnd = make_diloco_round(r.tcfg, r.tfns, r.ttrain, r.dcfg)
    got, metrics = rnd(diloco_init(r.tparams, r.dcfg), r.tbatches, mask,
                       torch.tensor(THR))
    _assert_trees_equal(got, ref)
    assert torch.isfinite(metrics["loss"]).all()


@pytest.mark.parametrize("arch", list(CARRY_ARCHS))
def test_recurrent_round_matches_jax(arch):
    """The port's fused round against the reference's at f32 compute:
    the losses and every leaf of the state at the uncompressed rounds'
    tolerance (rtol 1e-5, atol 1e-4)."""
    r = _recurrent(arch, "float32")
    with jax.enable_x64(False):
        jr = jdl.make_diloco_round(r.jcfg, r.jfns, r.jtrain, r.jdcfg,
                                   donate=False)
        jd, jm = jr(jdl.diloco_init(r.jparams, r.jdcfg), r.jbatches,
                    jnp.ones(2), jnp.asarray(THR, jnp.float32))
    rnd = make_diloco_round(r.tcfg, r.tfns, r.ttrain, r.dcfg)
    td, tm = rnd(diloco_init(r.tparams, r.dcfg), r.tbatches, torch.ones(2),
                 torch.tensor(THR))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    _assert_close(_tflat(td), _jflat(jd), 1e-5, 1e-4)


# ---------------------------------------------- the port's own contracts --

@pytest.fixture(scope="module")
def p():
    """The port alone at the reference micro config's compute dtype."""
    cfg = treg.get_reduced_config(ARCH, **MICRO)
    fns = treg.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=8,
                                  global_batch=2), "cpu")
    return SimpleNamespace(cfg=cfg, fns=fns, params=params, data=data,
                           tcfg=TrainConfig(adamw=AdamWConfig(lr=3e-3),
                                            warmup_steps=2,
                                            total_steps=100),
                           dcfg=DiLoCoConfig(n_pods=2, inner_steps=4),
                           batches=data.batch_block(
                               np.arange(8).reshape(2, 4)))


@pytest.mark.parametrize("compress", [None, "int8", "topk"])
@pytest.mark.parametrize("mask", [(1.0, 1.0), (1.0, 0.0)])
def test_round_is_inner_steps_then_outer_step_bitwise(p, mask, compress):
    inner = make_inner_steps(p.cfg, p.fns, p.tcfg, p.dcfg)
    ref, _ = inner(diloco_init(p.params, p.dcfg, compress=compress),
                   p.batches)
    ref = outer_step(ref, p.dcfg, pod_mask=torch.tensor(mask),
                     compress=compress)
    rnd = make_diloco_round(p.cfg, p.fns, p.tcfg, p.dcfg, compress=compress)
    d0 = diloco_init(p.params, p.dcfg, compress=compress)
    before = {k: v.clone() for k, v in tree_paths(d0).items()}
    got, metrics = rnd(d0, p.batches, torch.tensor(mask), torch.tensor(THR))
    _assert_trees_equal(got, ref)
    assert metrics["loss"].shape == (2, 4)
    assert not metrics["suspect"].any()
    for k, v in tree_paths(d0).items():            # inputs untouched
        assert torch.equal(v, before[k]), k
    if compress is not None:
        assert any(v.abs().max() > 0
                   for v in tree_paths(got["pod_ef"]).values())


def test_supervised_poisoned_pod_equals_plain_round_with_a_hand_mask(p):
    def poisoned():
        return _poison(tree_map, diloco_init(p.params, p.dcfg,
                                             screen_window=16),
                       float("nan"))
    thr = torch.tensor(THR)
    sup = make_diloco_round(p.cfg, p.fns, p.tcfg, p.dcfg, screen_window=16,
                            supervise=True)
    got, m = sup(poisoned(), p.batches, torch.ones(2), thr)
    assert m["pod_bad"].tolist() == [False, True]
    assert bool(m["outer_ok"])
    assert m["pod_alive"].tolist() == [1.0, 0.0]
    plain = make_diloco_round(p.cfg, p.fns, p.tcfg, p.dcfg, screen_window=16)
    ref, _ = plain(poisoned(), p.batches, torch.tensor([1.0, 0.0]), thr)
    _assert_trees_equal(got, ref, keys=("global_params", "outer_m",
                                        "pod_params"))
    for v in tree_paths(got["global_params"]).values():
        assert torch.isfinite(v.float()).all()
    for v in tree_paths(got["pod_opt"]).values():
        assert not v[1].any()                     # pod 1: fresh moments
    assert max(v[0].float().abs().max().item()
               for v in tree_paths(got["pod_opt"]).values()) > 0
    assert got["screen"]["count"].tolist() == [4, 0]


def test_single_pod_flag_is_an_outer_no_op(p):
    dcfg = DiLoCoConfig(n_pods=1, inner_steps=4)
    rnd = make_diloco_round(p.cfg, p.fns, p.tcfg, dcfg, screen_window=16,
                            supervise=True)
    ones, thr = torch.ones(1), torch.tensor(THR)
    d1, m1 = rnd(diloco_init(p.params, dcfg, screen_window=16),
                 p.data.batch_block(np.arange(4)[None]), ones, thr)
    assert not m1["pod_bad"].any()
    poisoned = {**d1, "pod_params": tree_map(lambda x: x * float("nan"),
                                             d1["pod_params"])}
    d2, m2 = rnd(poisoned, p.data.batch_block(4 + np.arange(4)[None]),
                 ones, thr)
    assert m2["pod_bad"].all() and bool(m2["outer_ok"])
    _assert_trees_equal(d2, d1, keys=("global_params", "outer_m"))
    for gp, pp in zip(tree_paths(d2["global_params"]).values(),
                      tree_paths(d2["pod_params"]).values()):
        assert torch.equal(pp[0], gp)


def test_all_dead_outer_step_is_a_no_op(p):
    dcfg = DiLoCoConfig(n_pods=3, inner_steps=4)
    inner = make_inner_steps(p.cfg, p.fns, p.tcfg, dcfg)
    d, _ = inner(diloco_init(p.params, dcfg),
                 p.data.batch_block(np.arange(12).reshape(3, -1)))
    d = outer_step(d, dcfg)
    live, _ = inner(d, p.data.batch_block(100 + np.arange(12).reshape(3, -1)))
    out = outer_step(live, dcfg, pod_mask=torch.zeros(3))
    _assert_trees_equal(out, live, keys=("global_params", "outer_m"))
    for gp, pp in zip(tree_paths(out["global_params"]).values(),
                      tree_paths(out["pod_params"]).values()):
        for i in range(3):
            assert torch.equal(pp[i], gp)


def test_mesh_and_wire_shard_hop_are_refused(p):
    """What the mesh round still refuses: a mesh without the ("pod",
    "data", "model") axes, and pods that do not divide its pod axis; a
    wire format derived for a mesh that is not a DeviceMesh is the
    simulated hop, which runs.  The hop over a pod group itself:
    tests/test_torch_mesh.py."""
    from repro_torch.distributed.compression import wire_format_for
    from repro_torch.distributed.sharding import param_shapes, param_specs
    flat = SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="axes"):
        make_diloco_round(p.cfg, p.fns, p.tcfg, p.dcfg, mesh=flat)
    three = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                            size=lambda i: (4, 1, 1)[i])
    with pytest.raises(ValueError, match="do not divide"):
        make_diloco_round(p.cfg, p.fns, p.tcfg, p.dcfg, mesh=three)
    fmt = wire_format_for(param_shapes(p.cfg), param_specs(p.cfg),
                          {"pod": 1, "data": 1, "model": 1}, p.dcfg.n_pods,
                          method="int8")
    assert fmt.mesh is None
    d = diloco_init(p.params, p.dcfg, compress="int8")
    out = outer_step(d, p.dcfg, wire=fmt)
    ref = outer_step(d, p.dcfg, compress="int8")
    for a, b in zip(tree_paths(out).values(), tree_paths(ref).values()):
        assert torch.equal(a, b)


def test_wire_format_round_follows_its_lane_layout(p):
    """outer_step with a single-lane WireFormat is the legacy compressed
    step bitwise; a 2-lane layout quantizes each lane on its own."""
    from repro_torch.distributed.compression import WireFormat, WireLeaf
    d = diloco_init(p.params, p.dcfg, compress="int8")
    d = {**d, "pod_params": tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(1)),
        d["pod_params"])}
    one = WireFormat(method="int8", n_pods=2, layout=tree_map(
        lambda x: WireLeaf(counts=(1,) * x.dim()), p.params))
    _assert_trees_equal(outer_step(d, p.dcfg, wire=one),
                        outer_step(d, p.dcfg, compress="int8"))
    two = WireFormat(method="int8", n_pods=2, layout=tree_map(
        lambda x: WireLeaf(counts=((2,) if x.shape[0] % 2 == 0 else (1,))
                           + (1,) * (x.dim() - 1)), p.params))
    got = outer_step(d, p.dcfg, wire=two)
    for k, v in tree_paths(got).items():
        assert torch.isfinite(v.float()).all(), k


def test_forced_rollback_run_equals_clean_run(sup_runs):
    clean, forced = sup_runs["clean"][1], sup_runs["forced"][1]
    _assert_trees_equal(clean.d_state, forced.d_state)
    assert clean.mean_losses == forced.mean_losses
    tmp = sup_runs["forced"][2]
    assert any((tmp / "ta").iterdir()) and any((tmp / "tb").iterdir())


def test_restore_from_checkpoint_resumes_bitwise(m, sup_runs, tmp_path):
    def mk():
        return DiLoCoSupervisor(
            make_diloco_round(m.tcfg, m.tfns, m.ttrain, m.dcfg,
                              data=m.tdata, screen_window=16,
                              supervise=True),
            diloco_init(m.tparams, m.dcfg, screen_window=16), m.dcfg,
            FTConfig(checkpoint_dirs=(str(tmp_path / "a"),
                                      str(tmp_path / "b")),
                     checkpoint_every=8),
            liveness=_liveness(tisl, m))
    s2 = mk()
    s2.run(4)             # snapshots land at rounds 2 and 4, then a SEFI
    s3 = mk()             # a fresh process over the same replica dirs
    assert s3.restore_from_checkpoint() == 4
    s3.run(6)
    _assert_trees_equal(sup_runs["clean"][1].d_state, s3.d_state)


def test_persistent_outer_corruption_raises(tmp_path):
    dcfg = DiLoCoConfig(n_pods=2, inner_steps=4)

    def bad_round(d, grid, mask, thr):
        r = int(grid[0, 0]) // dcfg.inner_steps
        z = torch.zeros((2, 4), dtype=torch.bool)
        return d, {"loss": torch.ones((2, 4)), "grad_norm": torch.ones(
            (2, 4)), "nonfinite": z, "loss_spike": z, "gnorm_spike": z,
            "suspect": z, "pod_bad": torch.tensor([r == 0, False]),
            "pod_alive": mask, "outer_ok": torch.tensor(r != 1)}

    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=8)
    sup = DiLoCoSupervisor(bad_round,
                           {"step": torch.zeros((), dtype=torch.int32)},
                           dcfg, ft)
    with pytest.raises(RuntimeError, match="outer"):
        sup.run(4)
    assert sup.stats["rollbacks"] == ft.max_rollbacks_per_step


# ------------------------------------------------------------------ CLI --

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)


def test_diloco_cli_runs_on_cpu_when_asked():
    proc = _cli("--device", "cpu", "--diloco-pods", "2", "--inner-steps",
                "2", "--compress", "int8", "--constellation", "--steps", "8",
                "--force-rollback-at", "2")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "DiLoCo 2 pods x H=2, 4 rounds on cpu" in out
    assert "'rollbacks': 1" in out and "replay_verified_rounds" in out
    assert "MB/pod/outer-sync (int8)" in out and "less pod-axis" in out
    assert "flash-attention kernel launches 0" in out
    assert "constellation: round_time" in out


def test_diloco_cli_default_device_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    proc = _cli("--diloco-pods", "2", "--steps", "4")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "Traceback" not in proc.stderr
