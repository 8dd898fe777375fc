"""The port's RG-LRU hybrid (recurrentgemma) against the JAX package on
the reduced config: same params (exported through numpy), same inputs
(numpy, from a seed), f32 compute.  The JAX model runs its default
associative scan; the port's scan (kernel B4's plain version on the CPU)
is sequential, so the two sum in other orders."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_state as jds  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.models import decode_state as tds  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides; sums and transcendentals round in other orders, a
# few ulps per op compounded over the layers: 1e-4 for the model's
# logits and states, 1e-5 relative for the loss and its gradients
TOL_MODEL = 1e-4
ARCH = "recurrentgemma-2b"
# reference fields the port has no reader for: the scan switch, sharding
# hints and the decode-length hint
DROPPED = {"scan_impl", "fsdp_hints", "max_decode_len"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    """Leaves of a nested dict/tuple tree with "a/0"-style paths."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _leaves(sub).items()}
    if isinstance(tree, (tuple, list)):
        return {f"{i}/{p}" if p else str(i): v for i, sub in enumerate(tree)
                for p, v in _leaves(sub).items()}
    return {"": tree}


def _assert_trees_close(tree, jtree, tol=TOL_MODEL):
    got, want = _leaves(tree), _leaves(jax.tree.map(np.asarray, jtree))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = want[name]
        assert tuple(t.shape) == w.shape, name
        np.testing.assert_allclose(t.float().numpy(), np.float32(w),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jparams = jrg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = trg.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(seed=0, b=3, s=12, vocab=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lens = np.array([s, 5, 1][:b], np.int32)
    return toks, lens


def test_configs_match_reference_field_for_field():
    for get in ("get_config", "get_reduced_config"):
        j = dataclasses.asdict(getattr(jreg, get)(ARCH))
        t = dataclasses.asdict(getattr(treg, get)(ARCH))
        assert {k: v for k, v in j.items() if k not in DROPPED} == t
    assert [f.name for f in dataclasses.fields(trg.RGLRUConfig)] == \
        [f.name for f in dataclasses.fields(jrg.RGLRUConfig)
         if f.name not in DROPPED]


@pytest.mark.parametrize("full", [False, True])
def test_init_params_shapes_and_count_match_reference(full):
    get = "get_config" if full else "get_reduced_config"
    jcfg, tcfg = getattr(jreg, get)(ARCH), getattr(treg, get)(ARCH)
    jshapes = jax.eval_shape(lambda: jrg.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    want = {k: tuple(v.shape) for k, v in _leaves(jshapes).items()}
    got = {k: shape for k, (shape, _) in trg._param_specs(tcfg).items()}
    assert got == want
    assert tcfg.param_count() == jcfg.param_count()
    if full:
        assert tcfg.param_count() == 2_894_528_000


def test_init_params_seeded_and_shaped():
    cfg = treg.get_reduced_config(ARCH)
    a = trg.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    b = trg.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(t.dtype == torch.float32 for t in la.values())
    lam = a["rec_a"]["lam"]
    assert bool(((lam >= 0.5) & (lam <= 2.0)).all())
    assert bool((a["rec_b"]["norm"] == 1).all())


def test_params_from_jax_checks_names_and_shapes(model):
    jcfg, tcfg, jparams, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    bad = {**tree, "rec_a": {**tree["rec_a"],
                             "w_x": tree["rec_a"]["w_x"][:, :1]}}
    with pytest.raises(ValueError, match="rec_a/w_x"):
        trg.params_from_jax(bad, tcfg, "cpu")
    del tree["tail"]
    with pytest.raises(ValueError, match="names differ"):
        trg.params_from_jax(tree, tcfg, "cpu")


def test_geglu_matches_reference():
    rng = np.random.default_rng(1)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 5, 16), (16, 24), (16, 24)))
    wo = rng.standard_normal((24, 16)).astype(np.float32)
    got = tl.geglu(_t(x), _t(wg), _t(wu), _t(wo))
    want = jl.geglu(x, wg, wu, wo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ring_decode_attention_at_head_dim_256_matches_reference():
    """recurrentgemma-2b's decode call: one query row, MQA (10 heads on 1
    kv head), head_dim 256, a 48-slot ring with per-row kv_len (full,
    partial, one slot), causal=False.  The port sends it to B1 (its plain
    version on the CPU); the reference runs attention_ref."""
    rng = np.random.default_rng(2)
    b, w, h, dh = 3, 48, 10, 256
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    ck = rng.standard_normal((b, w, 1, dh)).astype(np.float32)
    cv = rng.standard_normal((b, w, 1, dh)).astype(np.float32)
    filled = np.array([w, 17, 1], np.int32)
    got = tl.attention(_t(q), _t(ck), _t(cv), causal=False,
                       kv_len=_t(filled))
    want = jl.attention_ref(q, ck, cv, causal=False, kv_len=filled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_forward_logits_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    toks, _ = _prompts(s=40)      # longer than the 16-token window
    want = jrg.forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = trg.forward(tparams, _t(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_MODEL, rtol=TOL_MODEL)


def test_prefill_cells_logits_and_every_state_leaf(model):
    """Ragged rows (full, 5 and 1 tokens of a 12-token bucket, and a
    bucket of 40 past the window, whose ring wraps): last-token logits
    and every state leaf, carries, conv tails and rings included."""
    jcfg, tcfg, jparams, tparams = model
    for s, lens in ((12, [12, 5, 1]), (40, [40, 23, 16])):
        toks, _ = _prompts(seed=s, s=s)
        lens = np.array(lens, np.int32)
        jl_, jc = jrg.prefill_cells(jparams, jnp.asarray(toks),
                                    jnp.asarray(lens), jcfg)
        with torch.no_grad():
            tl_, tc = trg.prefill_cells(tparams, _t(toks), _t(lens), tcfg)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_),
                                   atol=TOL_MODEL, rtol=TOL_MODEL)
        _assert_trees_close(tc, jc)


def _decode_both(model, n_steps, s=12, lens=(12, 5, 1)):
    """Prefill through both families' decode specs, then greedy decode
    steps; yields (port logits, JAX logits, port state, JAX state)."""
    jcfg, tcfg, jparams, tparams = model
    toks, _ = _prompts(seed=n_steps, s=s)
    lens = np.array(lens, np.int32)
    b = len(lens)
    jspec, tspec = jds.decode_spec(jcfg), tds.decode_spec(tcfg, "cpu")
    admit = np.ones(b, bool)
    jlog, jst = jspec.prefill(jparams, jspec.init_state(b, 64),
                              jnp.asarray(toks), jnp.asarray(lens),
                              jnp.asarray(admit))
    with torch.no_grad():
        tlog, tst = tspec.prefill(tparams, tspec.init_state(b, 64),
                                  _t(toks), _t(lens), _t(admit))
        yield tlog, jlog, tst, jst
        for _ in range(n_steps):
            nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
            jlog, jst = jspec.decode(jparams, jst, jnp.asarray(nxt))
            tlog, tst = tspec.decode(tparams, tst, _t(nxt))
            yield tlog, jlog, tst, jst


def test_ten_decode_steps_match_reference(model):
    for tlog, jlog, tst, jst in _decode_both(model, 10):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=TOL_MODEL, rtol=TOL_MODEL)
    _assert_trees_close(tst, jst)
    assert tst["pos"].tolist() == [22, 15, 11]


def test_ring_wraps_past_the_window(model):
    """24 decode steps after a 12-token prompt: positions run to 36, past
    the 16-slot ring twice; logits every step and the final rings."""
    for tlog, jlog, tst, jst in _decode_both(model, 24):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=TOL_MODEL, rtol=TOL_MODEL)
    _assert_trees_close(tst, jst)
    assert int(tst["pos"].max()) == 36 > 2 * model[1].window


@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_grads_match_reference(model, loss_chunk):
    """loss_fn and its gradients at f32 compute, through remat, the scan's
    backward (the VJP of the plain recurrence) and the chunked xent:
    1e-5 relative."""
    jcfg, tcfg, jparams, tparams = model
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jloss, jg = jax.value_and_grad(jrg.loss_fn)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jcfg)
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in _leaves(tparams).items()}
    params = {k: ({kk: flat[f"{k}/{kk}"] for kk in v} if isinstance(v, dict)
                  else flat[k]) for k, v in tparams.items()}
    tloss = trg.loss_fn(params, {"tokens": _t(toks), "labels": _t(labels)},
                        tcfg)
    grads = torch.autograd.grad(tloss, list(flat.values()))
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    jflat = {k: np.asarray(v) for k, v in _leaves(jg).items()}
    for name, g in zip(flat, grads):
        want = jflat[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def _chunked(model):
    jcfg, tcfg, jparams, tparams = model
    return (dataclasses.replace(jcfg, attn_impl="chunked"),
            dataclasses.replace(tcfg, attn_impl="chunked"), jparams, tparams)


def test_forward_with_chunked_attention_matches_reference(model):
    """attn_impl="chunked" (the dry run's setting): the windowed attention
    runs the online softmax over 512-position KV blocks on both sides; 600
    tokens make two blocks, the second padded, and the 16-token window
    masks most of each."""
    jcfg, tcfg, jparams, tparams = _chunked(model)
    toks, _ = _prompts(seed=7, b=2, s=600)
    want = jrg.forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = trg.forward(tparams, _t(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_MODEL, rtol=TOL_MODEL)


def test_loss_and_grads_with_chunked_attention_match_reference(model):
    """loss_fn and its gradients with attn_impl="chunked" at 520 tokens
    (two KV blocks): the group's remat around each block's own checkpoint
    on the port's side, jax.checkpoint inside the scan on the reference's;
    1e-5 relative."""
    jcfg, tcfg, jparams, tparams = _chunked(model)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 520)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jloss, jg = jax.value_and_grad(jrg.loss_fn)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jcfg)
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in _leaves(tparams).items()}
    params = {k: ({kk: flat[f"{k}/{kk}"] for kk in v} if isinstance(v, dict)
                  else flat[k]) for k, v in tparams.items()}
    tloss = trg.loss_fn(params, {"tokens": _t(toks), "labels": _t(labels)},
                        tcfg)
    grads = torch.autograd.grad(tloss, list(flat.values()))
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    jflat = {k: np.asarray(v) for k, v in _leaves(jg).items()}
    for name, g in zip(flat, grads):
        want = jflat[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_decode_step_with_a_scalar_pos_matches_reference(model):
    """`init_cache`'s scalar pos (the non-serving layout): a 3-token step
    from an empty cache, then one-token steps, against JAX decode_step."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(6)
    jc = jrg.init_cache(jcfg, 2, 32)
    tc = trg.init_cache(tcfg, 2, 32, device="cpu")
    toks = rng.integers(0, jcfg.vocab_size, (2, 3)).astype(np.int32)
    with torch.no_grad():
        for _ in range(4):
            jlog, jc = jrg.decode_step(jparams, jc, jnp.asarray(toks), jcfg)
            tlog, tc = trg.decode_step(tparams, tc, _t(toks), tcfg)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=TOL_MODEL, rtol=TOL_MODEL)
            toks = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    _assert_trees_close(tc, jc)
    assert int(tc["pos"]) == 6
