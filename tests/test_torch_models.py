"""The port's layers, transformer and registry against the JAX package on
the reduced demo config: same params (exported through numpy), same
inputs (numpy, from a seed), f32 compute."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides; the two frameworks sum and round transcendental
# functions in different orders, a few ulps per op, compounded over the
# layers: 2e-5 per layer op, 1e-4 for logits of the whole model
TOL_OP = 2e-5
TOL_MODEL = 1e-4
ARCH = "suncatcher-lm-100m"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_match_reference_field_for_field():
    for get in ("get_config", "get_reduced_config"):
        j = dataclasses.asdict(getattr(jreg, get)(ARCH))
        t = dataclasses.asdict(getattr(treg, get)(ARCH))
        assert j == t
    assert [f.name for f in dataclasses.fields(ttf.TransformerConfig)] == \
        [f.name for f in dataclasses.fields(jtf.TransformerConfig)]
    assert ttf.TransformerConfig() == ttf.TransformerConfig(
        **dataclasses.asdict(jtf.TransformerConfig()))


@pytest.mark.parametrize("full", [False, True])
def test_init_params_shapes_and_count_match_reference(full):
    get = "get_config" if full else "get_reduced_config"
    jcfg, tcfg = getattr(jreg, get)(ARCH), getattr(treg, get)(ARCH)
    jshapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    assert tcfg.param_count() == jcfg.param_count()
    if full:
        return                       # the full init is the chip's work
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat = {("layers/" + k): v for k, v in tp["layers"].items()}
    flat.update({k: v for k, v in tp.items() if k != "layers"})
    jflat = {("layers/" + k): v for k, v in jshapes["layers"].items()}
    jflat.update({k: v for k, v in jshapes.items() if k != "layers"})
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in jflat.items()}
    again = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert torch.equal(tp["embed"], again["embed"])


def test_params_from_jax_rejects_other_trees(model):
    jcfg, tcfg, jparams, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"] = dict(tree["layers"], extra=np.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        ttf.params_from_jax(tree, tcfg, "cpu")


# ------------------------------------------------------------- layers ----

def test_norms_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal((64,), np.float32)
    bias = rng.standard_normal((64,), np.float32)
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w)).numpy(),
                               jl.rms_norm(x, w), atol=TOL_OP, rtol=TOL_OP)
    np.testing.assert_allclose(tl.layer_norm(_t(x), _t(w), _t(bias)).numpy(),
                               jl.layer_norm(x, w, bias), atol=TOL_OP,
                               rtol=TOL_OP)
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])):
        jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16)
        tc, ts = tl.rope_cos_sin(_t(pos), 16)
        np.testing.assert_allclose(tc.numpy(), jc, atol=TOL_OP)
        np.testing.assert_allclose(ts.numpy(), js, atol=TOL_OP)
        xr = rng.standard_normal((2, 5, 4, 16), np.float32)
        np.testing.assert_allclose(
            tl.apply_rope(_t(xr), tc, ts).numpy(),
            jl.apply_rope(xr, jc, js), atol=TOL_OP, rtol=TOL_OP)
    wg, wu = (rng.standard_normal((64, 32), np.float32) for _ in range(2))
    wo = rng.standard_normal((32, 64), np.float32)
    np.testing.assert_allclose(
        tl.swiglu(_t(x), _t(wg), _t(wu), _t(wo)).numpy(),
        jl.swiglu(x, wg, wu, wo), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("q_offset,kv_len,window,causal", [
    (0, None, None, True),                          # training forward
    (3, 9, None, True),                             # scalar offset + len
    ("vec", "vec", None, True),                     # ragged prefill
    ("vec", "vec", 4, True),                        # + local window
    (0, None, None, False),
])
def test_attention_ref_matches_reference(q_offset, kv_len, window, causal):
    rng = np.random.default_rng(1)
    b, sq, skv, h, hkv, dh = 2, 6, 12, 4, 2, 16
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, skv, hkv, dh), np.float32)
    v = rng.standard_normal((b, skv, hkv, dh), np.float32)
    if q_offset == "vec":
        q_offset = np.array([0, 5], np.int32)
    if kv_len == "vec":
        kv_len = np.array([6, 11], np.int32)
    kw = dict(causal=causal, window=window)
    want = jl.attention_ref(q, k, v, q_offset=jnp.asarray(q_offset),
                            kv_len=None if kv_len is None
                            else jnp.asarray(kv_len), **kw)
    got = tl.attention_ref(
        _t(q), _t(k), _t(v),
        q_offset=_t(q_offset) if isinstance(q_offset, np.ndarray)
        else q_offset,
        kv_len=None if kv_len is None else _t(kv_len), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_OP, rtol=TOL_OP)


def test_attention_dispatches_decode_rows_to_the_kernel_wrappers():
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 1, 4, 64), np.float32))
    k = _t(rng.standard_normal((2, 32, 2, 64), np.float32))
    lens = torch.tensor([5, 32], dtype=torch.int32)
    from repro_torch.kernels.decode_attention import decode_attention
    assert torch.equal(tl.attention(q, k, k, kv_len=lens),
                       decode_attention(q, k, k, lens))
    ref = tl.attention_ref(q, k, k, causal=False, kv_len=lens)
    np.testing.assert_allclose(tl.attention(q, k, k, kv_len=lens).numpy(),
                               ref.numpy(), atol=TOL_OP, rtol=TOL_OP)


# -------------------------------------------------------------- model ----

def test_forward_logits_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 11))
    want = jtf.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    got = ttf.forward(tparams, _t(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_MODEL,
                               rtol=TOL_MODEL)


def test_decode_step_prefill_then_vector_pos_decode(model):
    """Ragged prefill (per-row last_idx) into a (B,)-pos cache, then
    per-row decode steps: logits match at every step."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    b, lb, max_len = 3, 16, 64
    lens = np.array([16, 5, 9], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, lb)).astype(np.int32)
    jc = jtf.init_cache(jcfg, b, max_len)
    jc["pos"] = jnp.zeros((b,), jnp.int32)
    tc = ttf.init_cache(tcfg, b, max_len, device="cpu")
    tc["pos"] = torch.zeros((b,), dtype=torch.int32)
    jlog, jc = jtf.decode_step(jparams, jc, jnp.asarray(tokens), jcfg,
                               last_idx=jnp.asarray(lens - 1))
    tlog, tc = ttf.decode_step(tparams, tc, _t(tokens), tcfg,
                               last_idx=_t(lens - 1))
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=TOL_MODEL,
                               rtol=TOL_MODEL)
    jc["pos"], tc["pos"] = jnp.asarray(lens), _t(lens)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jc = jtf.decode_step(jparams, jc, jnp.asarray(nxt), jcfg)
        tlog, tc = ttf.decode_step(tparams, tc, _t(nxt), tcfg)
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=TOL_MODEL,
                                   rtol=TOL_MODEL)
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])


def test_decode_step_scalar_pos_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    prompt = np.arange(7, dtype=np.int32)[None]
    jc, tc = jtf.init_cache(jcfg, 1, 64), ttf.init_cache(tcfg, 1, 64,
                                                         device="cpu")
    jlog, jc = jtf.decode_step(jparams, jc, jnp.asarray(prompt), jcfg)
    tlog, tc = ttf.decode_step(tparams, tc, _t(prompt), tcfg)
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=TOL_MODEL,
                               rtol=TOL_MODEL)
    tok = np.array([[int(np.argmax(jlog[0]))]], np.int32)
    jlog, _ = jtf.decode_step(jparams, jc, jnp.asarray(tok), jcfg)
    tlog, _ = ttf.decode_step(tparams, tc, _t(tok), tcfg)
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=TOL_MODEL,
                               rtol=TOL_MODEL)


def test_paged_decode_step_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    b, ps, mp, pool = 2, 16, 4, 10
    pos = np.array([17, 40], np.int32)
    kp = rng.standard_normal((jcfg.n_layers, pool + 1, ps, jcfg.n_kv_heads,
                              jcfg.hd), np.float32)
    vp = rng.standard_normal(kp.shape, np.float32)
    ptab = np.full((b, mp), pool, np.int32)
    ptab[0, :2] = [3, 7]
    ptab[1, :3] = [0, 9, 4]
    tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jcache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
              "ptab": jnp.asarray(ptab), "pos": jnp.asarray(pos)}
    tcache = {"kp": _t(kp), "vp": _t(vp), "ptab": _t(ptab), "pos": _t(pos)}
    jlog, jnew = jtf.paged_decode_step(jparams, jcache, jnp.asarray(tok),
                                       jcfg)
    tlog, tnew = ttf.paged_decode_step(tparams, tcache, _t(tok), tcfg)
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=TOL_MODEL,
                               rtol=TOL_MODEL)
    np.testing.assert_allclose(tnew["kp"].numpy(), jnew["kp"],
                               atol=TOL_MODEL, rtol=TOL_MODEL)
    np.testing.assert_array_equal(tnew["pos"].numpy(), jnew["pos"])
