"""The port's MoE FFN and MoE transformer (granite-moe, qwen3-moe) against
the JAX package: same params (exported through numpy), same inputs
(numpy, from a seed), f32 compute.  The slot tables are integers and
compared exactly, outputs within the stated tolerances."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro.models import moe as jm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides: the expert products and the softmax round in other
# orders, a few ulps per op; 2e-5 for one FFN call, 1e-4 for a model's
# logits and loss (the tolerances of tests/test_torch_models.py)
TOL_OP = 2e-5
TOL_MODEL = 1e-4
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(t, e, k, seed, d=16, f=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), np.float32)
    p = {"router": rng.standard_normal((d, e), np.float32),
         "wi_gate": rng.standard_normal((e, d, f), np.float32) * 0.3,
         "wi_up": rng.standard_normal((e, d, f), np.float32) * 0.3,
         "wo": rng.standard_normal((e, f, d), np.float32) * 0.3}
    return x, p


def _ref_slot_table(x, router, e, k, cf):
    """The reference's slot table, step for step from
    `repro.models.moe.moe_ffn` (which does not return it)."""
    t = x.shape[0]
    capacity = int(max(1, (k * t * cf) // e))
    weights, experts = jm.router_topk(jnp.asarray(x), jnp.asarray(router), k)
    flat_expert = experts.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(t), k)
    flat_weight = weights.reshape(-1)
    order = jnp.argsort(flat_expert)
    se, st, sw = flat_expert[order], flat_token[order], flat_weight[order]
    counts = jnp.bincount(se, length=e)
    seg_start = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k) - seg_start[se]
    keep = rank < capacity
    slot_token = jnp.full((e, capacity), t, jnp.int32)
    slot_weight = jnp.zeros((e, capacity), jnp.float32)
    se_c = jnp.where(keep, se, e - 1)
    rk_c = jnp.where(keep, rank, capacity - 1)
    slot_token = slot_token.at[se_c, rk_c].set(
        jnp.where(keep, st, t).astype(jnp.int32), mode="drop")
    slot_weight = slot_weight.at[se_c, rk_c].set(
        jnp.where(keep, sw, 0.0), mode="drop")
    return (np.asarray(slot_token), np.asarray(slot_weight),
            np.asarray(counts), capacity)


def _port_ffn(x, p, e, k, cf, act="swiglu"):
    return tm.moe_ffn(_t(x), {n: _t(v) for n, v in p.items()},
                      num_experts=e, top_k=k, capacity_factor=cf,
                      activation=act)


def _ref_ffn(x, p, e, k, cf, act="swiglu"):
    return np.asarray(jm.moe_ffn(jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, p),
                                 num_experts=e, top_k=k, capacity_factor=cf,
                                 activation=act))


def test_router_topk_breaks_ties_to_the_lower_expert():
    """Experts 1 and 4, and 2 and 6, have identical router columns, so
    their probabilities tie exactly: both sides pick the lower id first."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 16), np.float32)
    w = rng.standard_normal((16, 8), np.float32)
    w[:, 4] = w[:, 1]
    w[:, 6] = w[:, 2]
    w[:, 3] = w[:, 1] + 5.0          # a clear winner in many rows
    for k in (1, 2, 3, 5):
        jw, jix = jm.router_topk(jnp.asarray(x), jnp.asarray(w), k)
        tw, tix = tm.router_topk(_t(x), _t(w), k)
        np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL_OP,
                                   rtol=TOL_OP)
    both = (tix.numpy() == 1).any(1) & (tix.numpy() == 4).any(1)
    assert both.any()               # the ties do reach the chosen k


@pytest.mark.parametrize("t,e,k,cf,act", [
    (8, 4, 2, 1.25, "swiglu"), (16, 32, 8, 1.25, "swiglu"),
    (33, 8, 2, 1.0, "swiglu"), (5, 8, 3, 2.0, "swiglu"),
    (64, 16, 4, 1.25, "swiglu"), (2, 4, 2, 1.25, "swiglu"),
    (40, 4, 1, 0.5, "swiglu"), (24, 8, 2, 1.25, "gelu")])
def test_moe_ffn_matches_reference(t, e, k, cf, act):
    x, p = _inputs(t, e, k, seed=t * e + k)
    np.testing.assert_allclose(_port_ffn(x, p, e, k, cf, act).numpy(),
                               _ref_ffn(x, p, e, k, cf, act), atol=TOL_OP,
                               rtol=TOL_OP)
    ref_tok, ref_w, _, cap = _ref_slot_table(x, p["router"], e, k, cf)
    weights, experts = tm.router_topk(_t(x), _t(p["router"]), k)
    tok, w, _ = tm.slot_table(experts, weights, t, e, cap, torch.float32)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_allclose(w.numpy(), ref_w, atol=TOL_OP, rtol=TOL_OP)


def _planted(last: bool):
    """Routing that sends 5 tokens to expert 3 (the last of 4) or to
    expert 0, at capacity 2: the planted expert overflows."""
    t, e, k, d = 8, 4, 1, 16
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((t, d), np.float32)) + 0.1
    router = rng.standard_normal((d, e), np.float32) * 0.01
    hot = e - 1 if last else 0
    router[:, hot] += 1.0
    x[5:] *= -1.0                    # 3 tokens go elsewhere
    _, p = _inputs(t, e, k, seed=11)
    p["router"] = router
    return x, p, e, k, 1.0, hot


@pytest.mark.parametrize("last", [True, False], ids=["last", "earlier"])
def test_planted_overflow_slot_table_and_output(last):
    """The reference writes every dropped assignment to slot (E-1, C-1):
    when the last expert overflows, that slot ends up empty and the token
    that held it loses its expert output; when an earlier expert
    overflows, the slot keeps its token.  The port reproduces both."""
    x, p, e, k, cf, hot = _planted(last)
    ref_tok, ref_w, counts, cap = _ref_slot_table(x, p["router"], e, k, cf)
    assert counts[hot] > cap and cap == 2
    weights, experts = tm.router_topk(_t(x), _t(p["router"]), k)
    tok, w, slot = tm.slot_table(experts, weights, x.shape[0], e, cap,
                                 torch.float32)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_allclose(w.numpy(), ref_w, atol=TOL_OP, rtol=TOL_OP)
    if last:
        assert ref_tok[e - 1, cap - 1] == x.shape[0]      # emptied
        last_kept = (slot >= (e - 1) * cap) & (slot < e * cap)
        assert int(last_kept.sum()) == cap - 1            # one kept lost
    else:
        assert ref_tok[e - 1, cap - 1] != x.shape[0] or counts[e - 1] < cap
    np.testing.assert_allclose(_port_ffn(x, p, e, k, cf).numpy(),
                               _ref_ffn(x, p, e, k, cf), atol=TOL_OP,
                               rtol=TOL_OP)


def test_aux_load_balance_loss_matches_reference():
    x, p = _inputs(24, 8, 2, seed=3)
    j = float(jm.aux_load_balance_loss(jnp.asarray(x),
                                       jnp.asarray(p["router"]), 2, 8))
    t = float(tm.aux_load_balance_loss(_t(x), _t(p["router"]), 2, 8))
    assert t == pytest.approx(j, rel=TOL_OP)


def test_init_moe_params_shapes_and_scales():
    p = tm.init_moe_params(torch.Generator().manual_seed(0), 64, 32, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 8), "wi_gate": (8, 64, 32), "wi_up": (8, 64, 32),
        "wo": (8, 32, 64)}
    for name, std in (("router", 64 ** -0.5), ("wi_gate", 64 ** -0.5),
                      ("wo", 32 ** -0.5)):
        assert float(p[name].std()) == pytest.approx(std, rel=0.1)


class _Watch(TorchFunctionMode):
    """Records every torch function called, and whether any indexing
    took a boolean tensor."""

    def __init__(self):
        super().__init__()
        self.names, self.bool_index = set(), False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.add(getattr(func, "__name__", str(func)))
        if getattr(func, "__name__", "") in ("__getitem__", "__setitem__"):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            self.bool_index |= any(torch.is_tensor(i) and
                                   i.dtype == torch.bool for i in idx)
        return func(*args, **(kwargs or {}))


def test_moe_ffn_avoids_host_syncing_and_atomic_ops():
    """No op that syncs with the host on the card (bincount, nonzero,
    boolean-mask indexing, repeat_interleave) and no atomic accumulation
    (index_add, scatter_add) on the path; two calls are bitwise equal."""
    x, p = _inputs(16, 8, 2, seed=5)
    with _Watch() as watch:
        out = _port_ffn(x, p, 8, 2, 1.25)
    bad = {n for n in watch.names
           if any(s in n for s in ("bincount", "nonzero", "index_add",
                                   "scatter_add", "repeat_interleave",
                                   "masked_select", "unique"))}
    assert not bad and not watch.bool_index, (bad, watch.bool_index)
    assert "searchsorted" in watch.names and "argsort" in watch.names
    assert torch.equal(out, _port_ffn(x, p, 8, 2, 1.25))


# ----------------------------------------------------- MoE transformer ----

def test_configs_match_reference_field_for_field():
    for arch in ARCHS:
        for get in ("get_config", "get_reduced_config"):
            j = getattr(jreg, get)(arch)
            t = getattr(treg, get)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    assert treg.get_config(ARCHS[0]).param_count() == 1_334_887_424


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jreg.get_reduced_config(request.param, compute_dtype="float32")
    tcfg = treg.get_reduced_config(request.param, compute_dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_init_params_shapes_and_shared_expert_init(model):
    jcfg, tcfg, jparams, _ = model
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == \
        {k: v.shape for k, v in jparams["layers"].items()}
    assert set(tp) == set(jparams)
    # as in the reference, every layer starts from the same router and
    # experts
    for name in ("router", "moe_wi_gate", "moe_wi_up", "moe_wo"):
        w = tp["layers"][name]
        assert all(torch.equal(w[0], w[i]) for i in range(w.shape[0]))
    assert not torch.equal(tp["layers"]["wq"][0], tp["layers"]["wq"][1])


def test_forward_and_loss_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    j = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        t = ttf.forward(tparams, _t(toks).long(), tcfg).numpy()
    np.testing.assert_allclose(t, j, atol=TOL_MODEL, rtol=TOL_MODEL)
    for chunk in (0, 8):
        c_j, c_t = (dataclasses.replace(c, loss_chunk=chunk)
                    for c in (jcfg, tcfg))
        jl = float(jtf.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)},
                               c_j))
        with torch.no_grad():
            tl = float(ttf.loss_fn(tparams, {"tokens": _t(toks).long(),
                                             "labels": _t(labels).long()},
                                   c_t))
        assert tl == pytest.approx(jl, rel=TOL_MODEL)


def test_decode_step_matches_reference(model):
    """A ragged prefill (per-row positions, last_idx) then decode steps:
    every row of the call routes through one expert table, pads too."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    last = np.array([15, 4, 9], np.int32)
    jc = jtf.init_cache(jcfg, 3, 32)
    jc["pos"] = jnp.zeros(3, jnp.int32)
    tc = ttf.init_cache(tcfg, 3, 32, device="cpu")
    tc["pos"] = torch.zeros(3, dtype=torch.int32)
    jl, jc = jtf.decode_step(jparams, jc, jnp.asarray(toks), jcfg,
                             last_idx=jnp.asarray(last))
    tl, tc = ttf.decode_step(tparams, tc, _t(toks), tcfg,
                             last_idx=_t(last))
    for _ in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=TOL_MODEL, rtol=TOL_MODEL)
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        jl, jc = jtf.decode_step(jparams, jc, jnp.asarray(nxt), jcfg)
        tl, tc = ttf.decode_step(tparams, tc, _t(nxt), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL_MODEL,
                               rtol=TOL_MODEL)
