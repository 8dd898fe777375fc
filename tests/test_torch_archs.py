"""The port's remaining transformer branches against the JAX package, on
the reduced widths of the six configs that need them: minicpm-2b
(mu-P scales, MHA), stablelm-12b (LayerNorm, untied head), command-r-35b
(parallel block, logit scale), qwen2.5-32b (QKV bias), qwen2-vl-2b
(M-RoPE, "vlm" batches) and musicgen-medium (four codebooks, sinusoidal
positions, GELU MLP).  Same params (exported through numpy), same inputs
(numpy, from a seed), f32 compute; tolerances from
tests/test_kernels.py::_tol (2e-5 at f32), relative and absolute."""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.train import DataConfig as JDataConfig  # noqa: E402
from repro.train import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.decode_state import decode_spec, paged_spec  # noqa: E402,E501
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501
from repro_torch.train import (DataConfig, FaultTolerantTrainer,  # noqa: E402
                               FTConfig, SyntheticLM, TrainConfig,
                               init_train_state, make_fused_steps,
                               make_train_step)
from repro_torch.train.tree import tree_paths  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5                      # tests/test_kernels.py::_tol(float32)
ROOT = Path(__file__).resolve().parents[1]
TOKEN_LMS = ["minicpm-2b", "stablelm-12b", "command-r-35b", "qwen2.5-32b"]
ARCHS = TOKEN_LMS + ["qwen2-vl-2b", "musicgen-medium"]
# published sizes (total params) of the full configs, as
# tests/test_archs_smoke.py bounds them
PARAM_BOUNDS = {"minicpm-2b": (2.2e9, 3.0e9), "stablelm-12b": (10e9, 13.5e9),
                "command-r-35b": (27e9, 37e9), "qwen2.5-32b": (29e9, 36e9),
                "qwen2-vl-2b": (1.2e9, 1.8e9),
                "musicgen-medium": (1.1e9, 1.8e9)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


_MODELS = {}


def _model(arch, **over):
    """(jcfg, tcfg, jparams, tparams) at reduced widths, f32 compute."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        over = dict(compute_dtype="float32", **over)
        jcfg = jreg.get_reduced_config(arch, **over)
        tcfg = treg.get_reduced_config(arch, **over)
        jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = ttf.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
        _MODELS[key] = jcfg, tcfg, jparams, tparams
    return _MODELS[key]


def _tokens(cfg, rng, b, s):
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _mrope_positions(rng, b, s):
    """(3, B, S) t/h/w ids, as an image patch grid would give them:
    increasing along the sequence, the three axes apart."""
    base = np.cumsum(rng.integers(0, 2, (b, s)), axis=1)
    return np.stack([base, base + rng.integers(0, 3, (b, s)),
                     base + rng.integers(0, 5, (b, s))]).astype(np.int32)


# ------------------------------------------------------------ configs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    for get in ("get_config", "get_reduced_config"):
        assert dataclasses.asdict(getattr(jreg, get)(arch)) == \
            dataclasses.asdict(getattr(treg, get)(arch))
    jmod = importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_"))
    assert treg.input_kind(arch) == jreg.input_kind(arch)
    assert treg.lr_schedule(arch) == getattr(jmod, "LR_SCHEDULE", "cosine")


def test_registry_lists_every_reference_arch_in_order():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.lr_schedule("minicpm-2b") == "wsd"
    assert treg.input_kind("musicgen-medium") == "codebooks"
    assert treg.input_kind("qwen2-vl-2b") == "vlm"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_shapes_match_reference(arch):
    full_j, full_t = jreg.get_config(arch), treg.get_config(arch)
    assert full_t.param_count() == full_j.param_count()
    lo, hi = PARAM_BOUNDS[arch]
    assert lo <= full_t.param_count() <= hi
    jcfg, tcfg, jparams, tparams = _model(arch)
    assert tcfg.param_count() == jcfg.param_count()
    own = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for tree in (tparams, own):
        flat = {k: tuple(v.shape) for k, v in tree_paths(tree).items()}
        jflat = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
                 for path, leaf in
                 jax.tree_util.tree_flatten_with_path(jparams)[0]}
        assert flat == jflat
    assert ("mlp_norm" in own["layers"]) == (not tcfg.parallel_block)


def test_cast_params_gives_one_head_per_codebook():
    _, tcfg, _, tparams = _model("musicgen-medium")
    cast = ttf.cast_params(tparams, tcfg)
    assert tuple(cast["head"].shape) == (tcfg.n_codebooks, tcfg.d_model,
                                         tcfg.vocab_size)
    tied = dataclasses.replace(tcfg, tie_embeddings=True)
    p = ttf.init_params(torch.Generator().manual_seed(1), tied, "cpu")
    assert torch.equal(ttf.cast_params(p, tied)["head"],
                       p["embed"].transpose(1, 2))


# ------------------------------------------------------------- layers ----

@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((4, 2, 2), 16)])
def test_mrope_cos_sin_matches_reference(sections, hd):
    pos = _mrope_positions(np.random.default_rng(0), 2, 9)
    jc, js = jl.mrope_cos_sin(jnp.asarray(pos), hd, sections)
    tc, ts = tl.mrope_cos_sin(_t(pos), hd, sections)
    _close(tc, jc)
    _close(ts, js)
    with pytest.raises(ValueError, match="sections"):
        tl.mrope_cos_sin(_t(pos), hd + 2, sections)


def test_gelu_mlp_and_geglu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24), np.float32)
    wi, wg = (rng.standard_normal((24, 40), np.float32) for _ in range(2))
    bi = rng.standard_normal((40,), np.float32)
    wo = rng.standard_normal((40, 24), np.float32) * 0.1
    bo = rng.standard_normal((24,), np.float32)
    _close(tl.gelu_mlp(_t(x), _t(wi), _t(bi), _t(wo), _t(bo)),
           jl.gelu_mlp(x, wi, bi, wo, bo), 1e-4)
    _close(tl.geglu(_t(x), _t(wg), _t(wi), _t(wo)),
           jl.geglu(x, wg, wi, wo), 1e-4)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv_matches_reference(n_rep):
    k = np.random.default_rng(2).standard_normal((2, 5, 2, 8), np.float32)
    np.testing.assert_array_equal(tl.repeat_kv(_t(k), n_rep).numpy(),
                                  jl.repeat_kv(k, n_rep))


@pytest.mark.parametrize("q_offset,kv_len,window,causal,kv_block", [
    (0, None, None, True, 4),            # training forward, 4 | Skv
    (0, None, None, False, 5),           # kv_block not dividing Skv
    (3, 9, None, True, 5),               # scalar offset and length
    ("vec", "vec", None, True, 5),       # ragged prefill
    ("vec", "vec", 4, True, 7),          # + local window
    (0, "vec", None, True, 512),         # one block wider than Skv
])
def test_attention_chunked_matches_reference(q_offset, kv_len, window,
                                             causal, kv_block):
    rng = np.random.default_rng(3)
    b, sq, skv, h, hkv, dh = 2, 6, 12, 6, 2, 16
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, skv, hkv, dh), np.float32)
    v = rng.standard_normal((b, skv, hkv, dh), np.float32)
    if q_offset == "vec":
        q_offset = np.array([0, 5], np.int32)
    if kv_len == "vec":
        kv_len = np.array([6, 11], np.int32)
    kw = dict(causal=causal, window=window, kv_block=kv_block)
    want = jl.attention_chunked(
        q, k, v, q_offset=jnp.asarray(q_offset),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw)
    tq = _t(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
    tk = None if kv_len is None else (_t(kv_len) if isinstance(
        kv_len, np.ndarray) else kv_len)
    got = tl.attention_chunked(_t(q), _t(k), _t(v), q_offset=tq, kv_len=tk,
                               **kw)
    _close(got, want)
    # and the plain attention on the same call (the recurrence is exact)
    ref = tl.attention_ref(_t(q), _t(k), _t(v), q_offset=tq, kv_len=tk,
                           causal=causal, window=window)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("q_offset,kv_len,window,causal,kv_block", [
    (0, None, None, True, 4),
    (3, 9, None, True, 5),
    ("vec", "vec", None, True, 5),
    ("vec", "vec", 4, True, 7),          # + local window
    (6, None, 3, True, 4),               # the first block fully masked
])
def test_attention_chunked_gradients_match_reference(
        q_offset, kv_len, window, causal, kv_block, monkeypatch):
    """The gradients of q, k and v through the per-block checkpoint
    against jax.grad of the reference's scan (jax.checkpoint per block),
    and bitwise against the same loop without the checkpoint."""
    rng = np.random.default_rng(7)
    b, sq, skv, h, hkv, dh = 2, 6, 12, 6, 2, 16
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, skv, hkv, dh), np.float32)
    v = rng.standard_normal((b, skv, hkv, dh), np.float32)
    go = rng.standard_normal((b, sq, h, dh), np.float32)
    if q_offset == "vec":
        q_offset = np.array([0, 5], np.int32)
    if kv_len == "vec":
        kv_len = np.array([6, 11], np.int32)
    kw = dict(causal=causal, window=window, kv_block=kv_block)
    want = jax.grad(lambda *a: jnp.sum(jl.attention_chunked(
        *a, q_offset=jnp.asarray(q_offset),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw) * go),
        argnums=(0, 1, 2))(q, k, v)
    tq = _t(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
    tk = None if kv_len is None else (_t(kv_len) if isinstance(
        kv_len, np.ndarray) else kv_len)

    def grads():
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        out = tl.attention_chunked(*leaves, q_offset=tq, kv_len=tk, **kw)
        return out, torch.autograd.grad(out, leaves, _t(go))

    out, got = grads()
    for g, w in zip(got, want):
        _close(g, w)
    monkeypatch.setattr(tl, "checkpoint", lambda fn, *a, **_: fn(*a))
    out_plain, plain = grads()
    assert torch.equal(out, out_plain)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


def test_attention_routes_chunked_only_where_no_kernel_does():
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((2, 6, 4, 16), np.float32))
    k = _t(rng.standard_normal((2, 6, 2, 16), np.float32))
    off = torch.tensor([0, 3], dtype=torch.int32)
    lens = torch.tensor([6, 9], dtype=torch.int32)
    got = tl.attention(q, k, k, impl="chunked", q_offset=off, kv_len=lens)
    assert torch.equal(got, tl.attention_chunked(q, k, k, q_offset=off,
                                                 kv_len=lens))
    # a full-sequence call stays on the flash route, one row on decode
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    assert torch.equal(tl.attention(q, k, k, impl="chunked"),
                       flash_attention(q, k, k))
    assert torch.equal(tl.attention(q[:, :1], k, k, impl="chunked",
                                    kv_len=lens),
                       decode_attention(q[:, :1], k, k, lens))


# -------------------------------------------------------------- model ----

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(5)
    toks = _tokens(jcfg, rng, 2, 11)
    pos = _mrope_positions(rng, 2, 11) if jcfg.mrope_sections else None
    want = jtf.forward(jparams, jnp.asarray(toks), jcfg,
                       positions=None if pos is None else jnp.asarray(pos))
    got = ttf.forward(tparams, _t(toks), tcfg,
                      positions=None if pos is None else _t(pos))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("arch,attn_impl", [(a, "ref") for a in ARCHS]
                         + [("stablelm-12b", "chunked")])
def test_loss_fn_matches_reference(arch, attn_impl):
    jcfg, tcfg, jparams, tparams = _model(arch, attn_impl=attn_impl)
    kind = treg.input_kind(arch)
    with jax.enable_x64(False):
        jdata = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size,
                                         seq_len=16, global_batch=2, seed=3,
                                         n_codebooks=jcfg.n_codebooks,
                                         kind=kind))
        jbatch = jdata.batch_at(0)
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    _close(ttf.loss_fn(tparams, tbatch, tcfg),
           jtf.loss_fn(jparams, jbatch, jcfg))


def test_chunked_attention_forward_matches_reference():
    """attn_impl="chunked" through the model: the multi-row prefill calls
    with per-row offsets take the chunked path on both sides."""
    jcfg, tcfg, jparams, tparams = _model("stablelm-12b",
                                          attn_impl="chunked")
    rng = np.random.default_rng(6)
    toks = _tokens(jcfg, rng, 3, 12)
    lens = np.array([12, 5, 9], np.int32)
    jc = jtf.init_cache(jcfg, 3, 64)
    jc["pos"] = jnp.asarray([0, 2, 7], jnp.int32)
    tc = ttf.init_cache(tcfg, 3, 64, device="cpu")
    tc["pos"] = torch.tensor([0, 2, 7], dtype=torch.int32)
    jlog, _ = jtf.decode_step(jparams, jc, jnp.asarray(toks), jcfg,
                              last_idx=jnp.asarray(lens - 1))
    tlog, _ = ttf.decode_step(tparams, tc, _t(toks), tcfg,
                              last_idx=_t(lens - 1))
    _close(tlog, jlog)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_prefill_then_per_slot_decode(arch):
    """Prefill into a (B,)-pos cache, then per-row decode steps: logits
    ((B, V), or (B, n_q, V) for musicgen) match at every step."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(7)
    b, lb = 3, 12
    toks = _tokens(jcfg, rng, b, lb)
    jc = jtf.init_cache(jcfg, b, 64)
    tc = ttf.init_cache(tcfg, b, 64, device="cpu")
    jc["pos"] = jnp.zeros((b,), jnp.int32)
    tc["pos"] = torch.zeros((b,), dtype=torch.int32)
    if jcfg.n_codebooks > 1:
        # no last_idx for several codebooks (as in the reference)
        jlog, jc = jtf.decode_step(jparams, jc, jnp.asarray(toks), jcfg)
        tlog, tc = ttf.decode_step(tparams, tc, _t(toks), tcfg)
        lens = np.full(b, lb, np.int32)
    else:
        lens = np.array([12, 5, 9], np.int32)
        kw = {}
        if jcfg.mrope_sections:
            pos = _mrope_positions(rng, b, lb)
            kw = dict(positions=pos)
        jlog, jc = jtf.decode_step(
            jparams, jc, jnp.asarray(toks), jcfg,
            last_idx=jnp.asarray(lens - 1),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tlog, tc = ttf.decode_step(tparams, tc, _t(toks), tcfg,
                                   last_idx=_t(lens - 1),
                                   **{k: _t(v) for k, v in kw.items()})
    assert tlog.shape == jlog.shape
    _close(tlog, jlog)
    jc["pos"], tc["pos"] = jnp.asarray(lens), _t(lens)
    for _ in range(4):
        nxt = _tokens(jcfg, rng, b, 1)
        jlog, jc = jtf.decode_step(jparams, jc, jnp.asarray(nxt), jcfg)
        tlog, tc = ttf.decode_step(tparams, tc, _t(nxt), tcfg)
        want_shape = ((b, jcfg.n_codebooks, jcfg.vocab_size)
                      if jcfg.n_codebooks > 1 else (b, jcfg.vocab_size))
        assert tuple(tlog.shape) == want_shape
        _close(tlog, jlog)
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
    _close(tc["k"], jc["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch):
    """Sinusoidal positions (musicgen reduced with one codebook), M-RoPE
    (qwen2-vl), the parallel block and the rest, through the page pool."""
    over = {"n_codebooks": 1} if arch == "musicgen-medium" else {}
    jcfg, tcfg, jparams, tparams = _model(arch, **over)
    rng = np.random.default_rng(8)
    b, ps, mp, pool = 2, 16, 4, 10
    pos = np.array([17, 40], np.int32)
    kp = rng.standard_normal((jcfg.n_layers, pool + 1, ps, jcfg.n_kv_heads,
                              jcfg.hd), np.float32)
    vp = rng.standard_normal(kp.shape, np.float32)
    ptab = np.full((b, mp), pool, np.int32)
    ptab[0, :2] = [3, 7]
    ptab[1, :3] = [0, 9, 4]
    tok = _tokens(jcfg, rng, b, 1)
    jcache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
              "ptab": jnp.asarray(ptab), "pos": jnp.asarray(pos)}
    tcache = {"kp": _t(kp), "vp": _t(vp), "ptab": _t(ptab), "pos": _t(pos)}
    jlog, jnew = jtf.paged_decode_step(jparams, jcache, jnp.asarray(tok),
                                       jcfg)
    tlog, tnew = ttf.paged_decode_step(tparams, tcache, _t(tok), tcfg)
    _close(tlog, jlog)
    _close(tnew["kp"], jnew["kp"])
    np.testing.assert_array_equal(tnew["pos"].numpy(), jnew["pos"])


def test_paged_layout_refuses_several_codebooks():
    _, tcfg, _, tparams = _model("musicgen-medium")
    with pytest.raises(ValueError, match="single-codebook"):
        paged_spec(decode_spec(tcfg, "cpu"), page_size=16, max_batch=2,
                   max_len=64)
    with pytest.raises(ValueError, match="codebook"):
        ttf.paged_decode_step(tparams, {}, torch.zeros(2, 4, 1,
                                                       dtype=torch.int32),
                              tcfg)


# ------------------------------------------------------------ serving ----

_JAX_STREAMS = {}


def _workload(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(sz)).astype(np.int32)
            for sz in rng.integers(3, 30, size=n)]


def _serve(eng, req_cls, prompts):
    """Odd uids sample at temperature 3 (off the greedy path of a random
    model's peaked logits), even ones are greedy."""
    for uid, p in enumerate(prompts):
        eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=7,
                           temperature=3.0 if uid % 2 else 0.0))
    return {r.uid: r.generated for r in eng.run()}


def _ecfg(cls, **kw):
    return cls(**dict(dict(max_batch=3, max_len=64, decode_block=4, seed=7),
                      **kw))


def _jax_streams(arch):
    """The JAX engine's streams (dense, decode_block 4; the reference
    holds paged and decode_block 1 bitwise equal to them)."""
    if arch not in _JAX_STREAMS:
        jcfg, _, jparams, _ = _model(arch)
        eng = JServingEngine(jcfg, jreg.model_fns(jcfg), jparams,
                             _ecfg(JEngineConfig))
        _JAX_STREAMS[arch] = _serve(eng, JRequest,
                                    _workload(jcfg.vocab_size))
    return _JAX_STREAMS[arch]


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("page_size", [0, 16])
@pytest.mark.parametrize("arch", TOKEN_LMS)
def test_engine_streams_match_jax_engine(arch, page_size, block):
    _, tcfg, _, tparams = _model(arch)
    eng = ServingEngine(tcfg, treg.model_fns(tcfg), tparams,
                        _ecfg(EngineConfig, page_size=page_size,
                              decode_block=block,
                              prefix_cache=2 if page_size else 0))
    got = _serve(eng, Request, _workload(tcfg.vocab_size))
    assert got == _jax_streams(arch)
    assert all(len(v) == 7 for v in got.values())


# --------------------------------------------------------------- data ----

@pytest.mark.parametrize("kind,vocab", [("codebooks", 64), ("codebooks", 2048),
                                        ("vlm", 128), ("vlm", 151936)])
def test_synthetic_lm_kinds_match_reference_bitwise(kind, vocab):
    cfg = dict(vocab_size=vocab, seq_len=32, global_batch=4, seed=0,
               n_codebooks=4 if kind == "codebooks" else 1, kind=kind)
    data = SyntheticLM(DataConfig(**cfg), "cpu")
    with jax.enable_x64(False):
        jdata = JSyntheticLM(JDataConfig(**cfg))
        wants = [jax.tree.map(np.asarray, jdata.batch_at(step))
                 for step in range(3)]
        jblock = jax.tree.map(np.asarray, jdata.batch_block(np.arange(2, 5)))
    for step, want in enumerate(wants):
        got = data.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    block = data.batch_block(np.arange(2, 5))
    assert set(block) == set(jblock)
    for k in jblock:
        np.testing.assert_array_equal(block[k].numpy(), jblock[k])
        assert torch.equal(block[k][0], data.batch_at(2)[k])


def test_synthetic_lm_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        SyntheticLM(DataConfig(kind="image"), "cpu")


# ----------------------------------------------------------- training ----

def _equal_trees(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    return list(pa) == list(pb) and all(torch.equal(pa[n], pb[n])
                                        for n in pa)


def _run_and_run_fused(arch, tmp_path):
    """FaultTolerantTrainer.run for 8 steps and run_fused (K 4) for 8
    from the same state on the reduced config at f32: (losses of each,
    the two trainers)."""
    cfg = treg.get_reduced_config(arch, compute_dtype="float32")
    fns = treg.model_fns(cfg)
    tcfg = TrainConfig(warmup_steps=2, total_steps=8)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2,
                                  n_codebooks=getattr(cfg, "n_codebooks", 1),
                                  kind=treg.input_kind(arch)), "cpu")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                             "cpu")
    step = make_train_step(cfg, fns, tcfg)
    runs = []
    for name, k in (("a", 1), ("b", 4)):
        ft = FTConfig(checkpoint_dirs=(str(tmp_path / name),),
                      checkpoint_every=100, drain_every=k)
        tr = FaultTolerantTrainer(
            step, state, data, ft,
            fused_steps=make_fused_steps(cfg, fns, tcfg) if k > 1 else None)
        hist = tr.run_fused(8) if k > 1 else tr.run(8)
        runs.append(([h["loss"] for h in hist], tr))
    return runs


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_run_equals_run_fused_bitwise(arch, tmp_path):
    """The positions leaf (qwen2-vl) and the codebook axis (musicgen)
    pass through the per-step loop and the fused block alike."""
    (losses, t1), (fused, t2) = _run_and_run_fused(arch, tmp_path)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert losses == fused
    assert _equal_trees(t1.state, t2.state)
    assert t2.stats["drains"] == 2


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m",
                                  "recurrentgemma-2b"])
def test_family_run_equals_run_fused_bitwise(arch, tmp_path):
    """The MoE dispatch, the xLSTM cells and the RG-LRU scan, with their
    backwards, pass through the per-step loop and the fused block alike:
    losses and final state bitwise.  At batch 2 x seq 16 granite-moe's
    loss does not fall over 8 steps (36.7 -> 39.7: too few tokens a
    step), so this holds the losses finite only; that training moves
    the three families as the reference moves them is
    tests/test_torch_family_training.py's eight steps against JAX."""
    (losses, t1), (fused, t2) = _run_and_run_fused(arch, tmp_path)
    assert np.isfinite(losses).all()
    assert losses == fused
    assert _equal_trees(t1.state, t2.state)
    assert t2.stats["drains"] == 2


# ------------------------------------------------------------ launchers --

def _cli(mod, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", mod, *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=240)


@pytest.mark.parametrize("arch,sched,kind", [
    ("minicpm-2b", "wsd", "tokens"),
    ("musicgen-medium", "cosine", "codebooks"),
    ("qwen2-vl-2b", "cosine", "vlm"),
    ("granite-moe-1b-a400m", "cosine", "tokens"),
    ("xlstm-350m", "cosine", "tokens"),
    ("recurrentgemma-2b", "cosine", "tokens")])
def test_train_cli_trains_the_new_archs_on_cpu(arch, sched, kind):
    proc = _cli("repro_torch.launch.train", "--arch", arch, "--device",
                "cpu", "--steps", "4", "--seq-len", "16", "--batch", "2")
    assert proc.returncode == 0, proc.stderr
    assert f"({sched} schedule, {kind} batches)" in proc.stdout


def test_train_cli_runs_the_reference_launchers_moe_diloco_example():
    """The reference launcher's docstring example for granite-moe
    (`--diloco-pods 2 --inner-steps 8 --compress int8`), on the CPU."""
    proc = _cli("repro_torch.launch.train", "--arch", "granite-moe-1b-a400m",
                "--device", "cpu", "--diloco-pods", "2", "--inner-steps", "8",
                "--compress", "int8", "--steps", "16", "--seq-len", "16",
                "--batch", "2")
    assert proc.returncode == 0, proc.stderr
    assert "DiLoCo 2 pods x H=8, 2 rounds on cpu" in proc.stdout
    assert "(int8)" in proc.stdout


def test_train_cli_schedule_flag_overrides_the_arch_default():
    proc = _cli("repro_torch.launch.train", "--arch", "minicpm-2b",
                "--device", "cpu", "--steps", "2", "--seq-len", "16",
                "--batch", "2", "--drain-every", "1", "--schedule", "cosine")
    assert proc.returncode == 0, proc.stderr
    assert "(cosine schedule, tokens batches)" in proc.stdout


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_serve_cli_refuses_non_token_archs(arch):
    proc = _cli("repro_torch.launch.serve", "--arch", arch, "--device",
                "cpu", "--requests", "2")
    assert proc.returncode != 0
    assert "token-LM" in proc.stderr and "Traceback" not in proc.stderr


def test_serve_cli_serves_a_new_token_arch_on_cpu():
    proc = _cli("repro_torch.launch.serve", "--arch", "command-r-35b",
                "--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-len", "64", "--max-new-tokens", "4",
                "--page-size", "16")
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout
