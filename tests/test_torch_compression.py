"""The port's delta codecs (`repro_torch.distributed.compression`) against
the JAX package's on the same inputs, made with numpy from a seed: the
legacy int8 and top-k codecs, the wire layout (`tiles_of`/`untile`, the
lane codecs, `ef_wire_roundtrip`) and the byte counts, all bitwise,
planted top-k ties and empty and scalar leaves included.  Then the
reference's own invariants (tests/test_compression.py) on the port.

The reference runs with jax's default 32-bit types (other test modules
turn on jax_enable_x64 process-wide)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as J  # noqa: E402
from repro_torch.distributed import compression as T  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    """Bitwise: same dtype, shape and bits."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _ties(n, seed):
    """Gaussian values with planted ties: rounded runs, equal magnitudes
    of opposite sign, repeated maxima and exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[::3] = np.round(x[::3], 1)
    x[1::7] = -x[::7][:len(x[1::7])]
    x[5::11] = 2.5
    x[6::13] = -2.5
    x[::17] = 0.0
    return x


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


# ------------------------------------------------- parity with the JAX ----

@pytest.mark.parametrize("n", [0, 1, 5, 255, 256, 257, 300, 1000, 65537])
def test_int8_codec_matches_jax_bitwise(n):
    x = _ties(n, n)
    jc, tc = J.int8_compress(jnp.asarray(x)), T.int8_compress(_t(x))
    _eq(tc["q"], jc["q"])
    _eq(tc["scale"], jc["scale"])
    assert tc["shape"] == tuple(jc["shape"]) and tc["n"] == jc["n"]
    _eq(T.int8_decompress(tc), J.int8_decompress(jc))
    assert T.int8_bytes(tc) == J.int8_bytes(jc)


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
@pytest.mark.parametrize("n", [1, 10, 600, 5000])
def test_topk_codec_matches_jax_bitwise_with_planted_ties(n, frac):
    """`jax.lax.top_k` keeps the lower index among equal magnitudes; the
    port's stable selection keeps the same indices in the same order."""
    x = _ties(n, 7 * n)
    jc, tc = J.topk_compress(jnp.asarray(x), frac), \
        T.topk_compress(_t(x), frac)
    _eq(tc["indices"], jc["indices"])
    _eq(tc["values"], jc["values"])
    _eq(T.topk_decompress(tc), J.topk_decompress(jc))
    assert T.topk_bytes(tc) == J.topk_bytes(jc)


def test_topk_ties_keep_the_lower_index():
    x = np.array([1.0, -3.0, 3.0, 0.5, -3.0, 3.0, 1.0], np.float32)
    want = np.asarray(J.topk_compress(jnp.asarray(x), 3 / 7)["indices"])
    got = T.topk_compress(_t(x), 3 / 7)["indices"].numpy()
    assert want.tolist() == got.tolist() == [1, 2, 4]


CASES = [((0,), (1,)), ((), ()), ((1,), (1,)), ((600,), (1,)),
         ((600,), (3,)), ((4, 6), (2, 1)), ((4, 6), (1, 2)),
         ((6, 40), (3, 2)), ((2, 3, 64), (2, 1, 4)), ((33, 12), (3, 2)),
         ((5, 7), (1, 1)), ((512, 96), (4, 2))]


@pytest.mark.parametrize("shape,counts", CASES, ids=str)
def test_tiles_of_and_untile_match_jax_bitwise(shape, counts):
    x = _ties(int(np.prod(shape)), 3).reshape(shape)
    jt, tt = J.tiles_of(jnp.asarray(x), counts), T.tiles_of(_t(x), counts)
    _eq(tt, jt)
    _eq(T.untile(tt, counts, shape), J.untile(jt, counts, shape))
    _eq(T.untile(tt, counts, shape), x)


@pytest.mark.parametrize("method", ["int8", "topk"])
@pytest.mark.parametrize("shape,counts", CASES, ids=str)
def test_ef_wire_roundtrip_matches_jax_bitwise(shape, counts, method):
    n = int(np.prod(shape))
    x = _ties(n, 11).reshape(shape)
    e = (0.01 * np.random.default_rng(12).standard_normal(n)
         ).astype(np.float32).reshape(shape)
    jp, js, jr = J.ef_wire_roundtrip(jnp.asarray(x), jnp.asarray(e), counts,
                                     method, topk_frac=0.05)
    tp, ts, tr = T.ef_wire_roundtrip(_t(x), _t(e), counts, method,
                                     topk_frac=0.05)
    _eq(ts, js)
    _eq(tr, jr)
    for k in ("q", "scale") if method == "int8" else ("values", "indices"):
        _eq(tp[k], jp[k])
    assert tp["n"] == jp["n"] and tp["shape"] == tuple(jp["shape"])


@pytest.mark.parametrize("method", [None, "int8", "topk"])
def test_wire_leaf_bytes_and_k_match_jax(method):
    for shape, counts in CASES + [((2, 300), (2, 1)), ((2, 150), (1, 1))]:
        for frac in (0.01, 0.013, 0.3):
            assert T.wire_leaf_bytes(shape, counts, method, 256, frac) == \
                J.wire_leaf_bytes(shape, counts, method, 256, frac)
    for m in (0, 1, 5, 256, 1000):
        assert T.topk_wire_k(m, 0.013) == J.topk_wire_k(m, 0.013)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_ef_compress_tree_and_decompress_match_jax(method):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((7, 40)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 33, 9)).astype(
                np.float32), "b": np.float32(1.5) * np.ones((300,),
                                                            np.float32)}}
    ef = {"a": 0.1 * tree["a"], "layers": {
        "w": np.zeros((2, 33, 9), np.float32),
        "b": rng.standard_normal(300).astype(np.float32)}}

    def tmap(fn, t):
        return {k: tmap(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    kw = {"frac": 0.05} if method == "topk" else {}
    jc, je, jb = J.ef_compress_tree(tmap(jnp.asarray, tree),
                                    tmap(jnp.asarray, ef), method, **kw)
    tc, te, tb = T.ef_compress_tree(tmap(_t, tree), tmap(_t, ef), method,
                                    **kw)
    assert tb == jb
    for path in (("a",), ("layers", "w"), ("layers", "b")):
        jl, tl = jc, tc
        jn, tn = je, te
        for k in path:
            jl, tl, jn, tn = jl[k], tl[k], jn[k], tn[k]
        _eq(tn, jn)
        for k in ("q", "scale") if method == "int8" else ("values",
                                                          "indices"):
            _eq(tl[k], jl[k])
    jd, td = J.decompress_tree(jc, method), T.decompress_tree(tc, method)
    _eq(td["layers"]["w"], jd["layers"]["w"])
    _eq(td["a"], jd["a"])
    assert T.tree_bytes_f32(tmap(_t, tree)) == \
        J.tree_bytes_f32(tmap(jnp.asarray, tree))


# ---------------------------------------------- the port's own contracts --

def test_byte_formulas_hand_computed():
    assert T.int8_bytes(T.int8_compress(torch.ones(600))) == 780
    assert T.int8_bytes(T.int8_compress(torch.ones(512))) == 2 * 260
    c = T.topk_compress(torch.ones(600), frac=0.01)
    assert c["values"].shape == (6,) and T.topk_bytes(c) == 48
    c = T.topk_compress(torch.ones(600, dtype=torch.bfloat16), frac=0.01)
    assert c["values"].dtype == torch.bfloat16 and T.topk_bytes(c) == 36
    assert T.topk_bytes(T.topk_compress(torch.ones(10), frac=0.01)) == 8
    assert T.wire_leaf_bytes((2, 300), (2, 1), "int8") == 2 * 2 * 260
    assert T.wire_leaf_bytes((2, 150), (2, 1), "topk", topk_frac=0.01) == 16
    assert T.wire_leaf_bytes((7, 11), (1, 1), None) == 4 * 77


@pytest.mark.parametrize("n", [1, 5, 255, 257, 1000, 1500])
def test_int8_roundtrip_error_bound(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n).astype(np.float32))
    sent = T.int8_decompress(T.int8_compress(x))
    bound = x.abs().max().item() / 254.0 * (1.0 + 1e-5) + 1e-9
    assert (sent - x).abs().max().item() <= bound


@pytest.mark.parametrize("method", ["int8", "topk"])
@pytest.mark.parametrize("n", [5, 256, 300, 1000])
def test_single_lane_wire_matches_legacy_bitwise(method, n):
    rng = np.random.default_rng(n)
    x = _t(rng.standard_normal(n).astype(np.float32))
    e = _t(0.01 * rng.standard_normal(n).astype(np.float32))
    kw = {"frac": 0.01} if method == "topk" else {}
    _, sent_l, resid_l = T.ef_roundtrip(x, e, method, **kw)
    _, sent_w, resid_w = T.ef_wire_roundtrip(x, e, (1,), method,
                                             topk_frac=0.01)
    assert torch.equal(sent_l, sent_w) and torch.equal(resid_l, resid_w)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_ef_invariant_and_unbiased_over_rounds(method):
    """sent + residual == x + ef bitwise, and error feedback makes the
    decoded running mean of a repeated value converge to it."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((33, 12)).astype(np.float32))
    e = _t(0.1 * rng.standard_normal((33, 12)).astype(np.float32))
    _, sent, resid = T.ef_wire_roundtrip(x, e, (3, 2), method)
    assert torch.equal(resid, x + e - sent)
    x = _t(rng.standard_normal(700).astype(np.float32))
    ef, acc, n_rounds = torch.zeros_like(x), torch.zeros_like(x), 64
    for _ in range(n_rounds):
        _, sent, ef = T.ef_wire_roundtrip(x, ef, (4,), method,
                                          topk_frac=0.05)
        acc = acc + sent
    np.testing.assert_allclose((acc + ef).numpy(), (n_rounds * x).numpy(),
                               rtol=1e-4, atol=1e-3)
    err = (acc / n_rounds - x).abs().max().item()
    assert err <= ef.abs().max().item() / n_rounds + 1e-5


def test_padding_edges():
    for n in (0, 1, 255, 256, 257):
        x = torch.arange(n, dtype=torch.float32) - n / 2
        q, scale = T.int8_wire_compress(x.reshape(1, -1))
        rows = -(-n // 256)
        assert q.shape == (1, rows, 256) and scale.shape == (1, rows, 1)
        assert T.int8_wire_decompress(q, scale, n).shape == (1, n)
    for method in ("int8", "topk"):
        z = torch.zeros(0)
        _, sent, resid = T.ef_wire_roundtrip(z, z, (1,), method)
        assert sent.shape == (0,) and resid.shape == (0,)
    x = torch.tensor([0.1, -3.0, 0.2, 0.0, 1.0])
    _, sent, _ = T.ef_wire_roundtrip(x, torch.zeros_like(x), (1,), "topk",
                                     topk_frac=0.01)
    assert sent.tolist() == [0.0, -3.0, 0.0, 0.0, 0.0]
    _, sent, _ = T.ef_wire_roundtrip(torch.tensor(2.5), torch.tensor(0.0),
                                     (), "int8")
    assert sent.shape == () and abs(sent.item() - 2.5) <= 2.5 / 254 + 1e-6
