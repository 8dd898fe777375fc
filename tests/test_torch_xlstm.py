"""The port's xLSTM (xlstm-350m) against the JAX package on the reduced
config: same params (exported through numpy), same inputs (numpy, from a
seed), f32 compute."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides; sums and transcendentals round in other orders, a
# few ulps per op compounded over the pairs and the exponential gates:
# 1e-4 relative for one block, the logits, the loss and the carries
# (logits of the reduced model reach ~60)
TOL = 1e-4
# the reference's own limits: chunked vs parallel mLSTM
# (tests/test_models.py::TestMLSTMChunked) and decode vs forward
# (TestDecodeParity)
TOL_CHUNK = dict(atol=5e-4, rtol=5e-3)
TOL_DECODE = dict(atol=3e-2, rtol=3e-2)
ARCH = "xlstm-350m"
# reference fields the port has no reader for: sharding hints, the
# attention switch and the decode-length hint
DROPPED = {"fsdp_hints", "attn_impl", "max_decode_len"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _leaves(sub).items()}
    if isinstance(tree, (tuple, list)):
        return {f"{i}/{p}" if p else str(i): v for i, sub in enumerate(tree)
                for p, v in _leaves(sub).items()}
    return {"": tree}


def _close(t, j, **tol):
    tol = tol or dict(atol=TOL, rtol=TOL)
    got, want = _leaves(t), _leaves(jax.tree.map(np.asarray, j))
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert tuple(v.shape) == want[name].shape, name
        np.testing.assert_allclose(v.detach().float().numpy(),
                                   np.float32(want[name]), err_msg=name,
                                   **tol)


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jparams = jx.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tx.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_match_reference_field_for_field():
    for get in ("get_config", "get_reduced_config"):
        j = dataclasses.asdict(getattr(jreg, get)(ARCH))
        t = dataclasses.asdict(getattr(treg, get)(ARCH))
        assert {k: v for k, v in j.items() if k not in DROPPED} == t
        assert getattr(treg, get)(ARCH).param_count() == \
            getattr(jreg, get)(ARCH).param_count()
    assert treg.get_config(ARCH).param_count() == 353_797_216


def test_init_params_shapes_match_and_names_are_checked(model):
    jcfg, tcfg, jparams, _ = model
    tp = tx.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    want = {k: v.shape for k, v in _leaves(jparams).items()}
    assert {k: tuple(v.shape) for k, v in _leaves(tp).items()} == want
    tree = jax.tree.map(np.asarray, jparams)
    bad = {**tree, "mlstm": {**tree["mlstm"], "w_q": tree["mlstm"]["w_q"][:1]}}
    with pytest.raises(ValueError, match="w_q"):
        tx.params_from_jax(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="extra"):
        tx.params_from_jax({**tree, "extra": np.zeros(2)}, tcfg, "cpu")


def _x(seed, b=2, s=10, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d),
                                                       np.float32)


def _pair_params(tparams, jparams, group, i=0):
    return ({k: v[i] for k, v in tparams[group].items()},
            {k: v[i] for k, v in jparams[group].items()})


@pytest.mark.parametrize("stateful", [False, True])
def test_slstm_block_matches_reference(model, stateful):
    jcfg, tcfg, jparams, tparams = model
    tl, jl = _pair_params(tparams, jparams, "slstm")
    x = _x(1)
    jstate = tstate = None
    if stateful:
        rng = np.random.default_rng(2)
        st = [rng.standard_normal((2, 4, 16), np.float32) for _ in range(4)]
        st[2] = st[2] - 1.0
        jstate, tstate = tuple(map(jnp.asarray, st)), tuple(map(_t, st))
    jy, jst = jx._slstm_block(jcfg, jnp.asarray(x), jl, state=jstate)
    ty, tst = tx._slstm_block(tcfg, _t(x), tl, state=tstate)
    _close(ty, jy)
    _close(tst, jst)


def test_mlstm_block_parallel_and_recurrent_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    tl, jl = _pair_params(tparams, jparams, "mlstm", 1)
    x = _x(3)
    jy, _ = jx._mlstm_block(jcfg, jnp.asarray(x), jl)
    ty, _ = tx._mlstm_block(tcfg, _t(x), tl)
    _close(ty, jy)
    rng = np.random.default_rng(4)
    h, dh = tcfg.n_heads, tcfg.hd
    st = (rng.standard_normal((2, h, dh, dh), np.float32),
          rng.standard_normal((2, h, dh), np.float32),
          rng.standard_normal((2, h), np.float32))
    jy, jst = jx._mlstm_block(jcfg, jnp.asarray(x[:, :1]), jl,
                              state=tuple(map(jnp.asarray, st)))
    ty, tst = tx._mlstm_block(tcfg, _t(x[:, :1]), tl,
                              state=tuple(map(_t, st)))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("s,chunk", [(128, 32), (96, 24), (100, 32)])
def test_mlstm_chunked_equals_parallel_and_reference(s, chunk):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 4, 32), np.float32)
               for _ in range(3))
    ifg = rng.standard_normal((2, s, 8), np.float32) * 2.0
    tq, tk, tv, ti = map(_t, (q, k, v, ifg))
    par = tx._mlstm_parallel(tq, tk, tv, ti).numpy()
    chk = tx._mlstm_chunked(tq, tk, tv, ti, chunk).numpy()
    np.testing.assert_allclose(chk, par, **TOL_CHUNK)
    jq, jk, jv, ji = map(jnp.asarray, (q, k, v, ifg))
    np.testing.assert_allclose(par, np.asarray(jx._mlstm_parallel(
        jq, jk, jv, ji)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(chk, np.asarray(jx._mlstm_chunked(
        jq, jk, jv, ji, chunk)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,chunk", [(12, 0), (40, 16)])
def test_forward_and_loss_match_reference(model, s, chunk):
    """Logits, and the loss with and without loss_chunk; s 40 past an
    mlstm_chunk of 16 takes the chunkwise form."""
    jcfg, tcfg, jparams, tparams = model
    if chunk:
        jcfg, tcfg = (dataclasses.replace(c, mlstm_chunk=chunk)
                      for c in (jcfg, tcfg))
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 128, (2, s)).astype(np.int32)
    labels = rng.integers(0, 128, (2, s)).astype(np.int32)
    j = np.asarray(jx.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        t = tx.forward(tparams, _t(toks).long(), tcfg).numpy()
    np.testing.assert_allclose(t, j, atol=TOL * np.abs(j).max(), rtol=TOL)
    for lc in (0, 4):
        cj, ct = (dataclasses.replace(c, loss_chunk=lc) for c in (jcfg, tcfg))
        jl = float(jx.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}, cj))
        with torch.no_grad():
            tl = float(tx.loss_fn(tparams, {"tokens": _t(toks).long(),
                                            "labels": _t(labels).long()},
                                  ct))
        assert tl == pytest.approx(jl, rel=TOL)


def test_loss_gradients_are_finite_under_remat(model):
    _, tcfg, _, tparams = model
    params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in tparams.items()}
    toks = torch.randint(0, 128, (2, 12), generator=torch.Generator()
                         .manual_seed(0))
    tx.loss_fn(params, {"tokens": toks, "labels": toks.roll(-1, 1)},
               tcfg).backward()
    grads = [p.grad for p in _leaves(params).values()]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


def test_decode_step_and_prefill_cells_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 128, (3, 12)).astype(np.int32)
    lens = np.array([12, 5, 1], np.int32)
    jl, js = jx.prefill_cells(jparams, jnp.asarray(toks), jnp.asarray(lens),
                              jcfg)
    tl, ts = tx.prefill_cells(tparams, _t(toks), _t(lens), tcfg)
    _close(tl, jl)
    _close(ts, js)
    for _ in range(4):
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        jl, js = jx.decode_step(jparams, js, jnp.asarray(nxt), jcfg)
        tl, ts = tx.decode_step(tparams, ts, _t(nxt), tcfg)
        _close(tl, jl)
        _close(ts, js)
    assert ts["pos"].tolist() == [16, 9, 5]


def test_decode_over_a_prompt_equals_forward_at_each_position(model):
    _, tcfg, _, tparams = model
    toks = _t(np.random.default_rng(7).integers(0, 128, (2, 10))).long()
    cache = tx.init_cache(tcfg, 2, 16, device="cpu")
    with torch.no_grad():
        ref = tx.forward(tparams, toks, tcfg)
        for t in range(10):
            lg, cache = tx.decode_step(tparams, cache, toks[:, t:t + 1],
                                       tcfg)
            np.testing.assert_allclose(lg.numpy(), ref[:, t].numpy(),
                                       **TOL_DECODE)


def test_init_cache_carries_are_f32_whatever_the_dtype():
    cfg = treg.get_reduced_config(ARCH)
    c = tx.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    leaves = [*c["slstm"], *c["mlstm"]]
    assert all(x.dtype == torch.float32 for x in leaves)
    assert torch.isinf(c["slstm"][2]).all() and torch.isinf(
        c["mlstm"][2]).all()
    assert tuple(c["mlstm"][0].shape) == (2, 2, 4, 32, 32)


def test_prefix_sums_are_in_order_f32_sums_and_no_float_cumsum(
        model, monkeypatch):
    """The mLSTM's log-forget prefix sums are the RG-LRU scan at a = 1:
    f32 sums taken in order, bitwise numpy's sequential float32 cumsum
    (torch's CPU cumsum of floats accumulates in double).  No float
    torch.cumsum remains on the training path, forward or backward,
    parallel or chunked: it has no deterministic CUDA kernel, and the
    card's training runs under torch.use_deterministic_algorithms."""
    x = np.random.default_rng(0).standard_normal((3, 70, 4)).astype(
        np.float32)
    got = tx._prefix_sum(torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(np.cumsum(x, axis=1,
                                                       dtype=np.float32)))
    real_fn, real_method = torch.cumsum, torch.Tensor.cumsum

    def guard(real):
        def cumsum(t, *a, **k):
            assert not t.is_floating_point(), "a float cumsum"
            return real(t, *a, **k)
        return cumsum
    monkeypatch.setattr(torch, "cumsum", guard(real_fn))
    monkeypatch.setattr(torch.Tensor, "cumsum", guard(real_method))
    _, tcfg, _, tparams = model
    params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in tparams.items()}
    for s, chunk in ((12, 256), (40, 16)):
        cfg = dataclasses.replace(tcfg, mlstm_chunk=chunk)
        toks = torch.randint(0, 128, (2, s), generator=torch.Generator()
                             .manual_seed(s))
        tx.loss_fn(params, {"tokens": toks, "labels": toks.roll(-1, 1)},
                   cfg).backward()
