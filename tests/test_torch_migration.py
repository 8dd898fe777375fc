"""Slot migration in the port against the JAX package: the four tree ops
of `models/decode_state.py` (`state_rows`, `merge_rows`, `delta_since`,
`delta_apply`) bitwise equal to the reference's on random trees, the
specs' wire bytes equal to the reference's, and the engine's migration
surface (export/import, delta replication into a standby store, standby
promotion) held to the reference's contract: an export and import on one
engine changes no bit, a generation moved mid-decode (dense, paged or an
RG-LRU carry) emits the tokens of an uninterrupted run (the JAX engine's,
greedy and sampled), a paged import equals a dense one, and imports on
another param version or max_len are refused.  Reduced configs, f32."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_state as jds  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models import decode_state as tds  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501
from repro_torch.train.tree import tree_map  # noqa: E402

torch.set_num_threads(1)
ARCHS = {"kv": "suncatcher-lm-100m", "carry": "recurrentgemma-2b"}
TEMPS = (0.0, 0.8, 3.0)     # greedy, the plane tests' T, and a hot draw


# ------------------------------------------------------------ tree ops ----

def _tree(kind, rng, b):
    """A random state tree, its slot axes and its length axes."""
    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 17, b).astype(np.int32)
    if kind == "kv":             # (L, B, M, Hkv, dh), length axis 2
        return ({"k": f32(2, b, 16, 2, 3), "v": f32(2, b, 16, 2, 3),
                 "pos": pos}, {"k": 1, "v": 1, "pos": 0},
                {"k": 2, "v": 2, "pos": -1})
    if kind == "slot-first":     # (B, M, D), length axis 1
        return ({"w": f32(b, 16, 5), "pos": pos}, {"w": 0, "pos": 0},
                {"w": 1, "pos": -1})
    # carry: RG-LRU-shaped (h, conv) pairs and a ring, all shipped whole
    return ({"rec_a": (f32(2, b, 5), f32(2, b, 3, 5)),
             "attn": (f32(2, b, 8, 1, 3), f32(2, b, 8, 1, 3)),
             "pos": pos}, {"rec_a": (1, 1), "attn": (1, 1), "pos": 0},
            {"rec_a": (-1, -1), "attn": (-1, -1), "pos": -1})


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as(v, fn) for v in tree)
    return fn(tree)


def _op_args(op, kind, seed):
    rng = np.random.default_rng(seed)
    b = 4
    state, axes, laxes = _tree(kind, rng, b)
    bundle = _tree(kind, rng, b)[0]
    idx = rng.permutation(b).astype(np.int32)
    src = rng.integers(0, b, b).astype(np.int32)
    mask = rng.random(b) < 0.6
    mask[0], mask[-1] = True, False
    starts = rng.integers(0, 16, b).astype(np.int32)
    width = 4 if seed % 2 == 0 else 16
    return {"state_rows": (state, axes, idx),
            "merge_rows": (state, bundle, axes, src, mask),
            "delta_since": (state, axes, laxes, idx, starts, width),
            "delta_apply": (state, bundle, axes, laxes, src, starts, mask),
            }[op]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["kv", "slot-first", "carry"])
@pytest.mark.parametrize("op", ["state_rows", "merge_rows", "delta_since",
                                "delta_apply"])
def test_tree_op_is_bitwise_the_reference(op, kind, seed):
    args = _op_args(op, kind, seed)
    want = getattr(jds, op)(*_inputs(args, jnp.asarray))
    got = getattr(tds, op)(*_inputs(args, torch.from_numpy))
    w, g = _flat(want), _flat(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(w, g)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def _inputs(args, fn):
    """Arrays and state trees through `fn`; axis declarations and widths
    as they are."""
    def is_axes(a):
        return all(isinstance(x, int) for x in _flat_ints(a))
    return [fn(a) if isinstance(a, np.ndarray) else
            _as(a, fn) if isinstance(a, dict) and not is_axes(a) else a
            for a in args]


def _flat_ints(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_ints(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat_ints(v)]
    return [tree]


# --------------------------------------------------------- the engines ----

def active_params(fns, cfg):
    """Seeded JAX params with the (tied) embedding scaled by 0.1: at the
    init scale the embedding dominates the residual and a random model
    repeats its input token, so its tokens would not show a corrupted
    cache; scaled, every token depends on the context and the sampled
    rows leave the greedy path."""
    params = fns.init(jax.random.PRNGKey(0), cfg)
    return {**params, "embed": params["embed"] * 0.1}


@pytest.fixture(scope="module")
def fam():
    """Per family: the JAX config, fns, params and the port's."""
    out = {}
    for kind, arch in ARCHS.items():
        jcfg = jreg.get_reduced_config(arch, compute_dtype="float32")
        tcfg = treg.get_reduced_config(arch, compute_dtype="float32")
        jfns = jreg.model_fns(jcfg)
        jparams = active_params(jfns, jcfg)
        conv = trg if kind == "carry" else ttf
        tparams = conv.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
        out[kind] = (jcfg, jfns, jparams, tcfg, treg.model_fns(tcfg),
                     tparams)
    return out


def _ecfg(cls, **kw):
    base = dict(max_batch=2, max_len=64, decode_block=4, seed=3)
    base.update(kw)
    return cls(**base)


def _prompt(uid, vocab, n=10):
    return np.random.default_rng(50 + uid).integers(0, vocab, n).astype(
        np.int32)


def _req(cls, uid, vocab, max_new=14):
    r = cls(uid=uid, prompt=_prompt(uid, vocab), max_new_tokens=max_new,
            temperature=TEMPS[uid % len(TEMPS)])
    r._seq = uid                 # the stream of an uninterrupted run
    return r


@pytest.fixture(scope="module")
def jax_streams(fam):
    """The JAX engine's uninterrupted streams of requests 0-2 (greedy,
    T 0.8, T 3.0) per family."""
    out = {}
    for kind, (jcfg, jfns, jparams, *_) in fam.items():
        eng = JServingEngine(jcfg, jfns, jparams, _ecfg(JEngineConfig,
                                                        max_batch=3))
        for uid in range(3):
            eng.submit(_req(JRequest, uid, jcfg.vocab_size))
        out[kind] = {r.uid: r.generated for r in eng.run()}
        assert all(len(set(v)) > 5 for v in out[kind].values())
    return out


LAYOUTS = {"dense": ("kv", {}), "paged": ("kv", dict(page_size=16)),
           "paged-small-pool": ("kv", dict(page_size=16, pool_pages=8)),
           "carry": ("carry", {})}


def _port(fam, layout, **kw):
    kind, lay = LAYOUTS[layout]
    _, _, _, tcfg, tfns, tparams = fam[kind]
    return ServingEngine(tcfg, tfns, tparams, _ecfg(EngineConfig,
                                                    **{**lay, **kw}))


def _busy(eng):
    return [i for i, s in enumerate(eng.slots) if s is not None]


def _snapshot(eng):
    """Every state leaf; for the paged layout the logical rows instead of
    the pool (an import may map other physical pages), positions past
    each row's pos cleared, and the free-page count."""
    cache = eng.cache
    if eng.ecfg.page_size:
        rows = eng.spec.export_rows(cache, torch.arange(eng.ecfg.max_batch))
        live = (torch.arange(rows["k"].shape[2])[None] <
                rows["pos"][:, None])[None, :, :, None, None]
        cache = {"k": rows["k"] * live, "v": rows["v"] * live,
                 "pos": rows["pos"], "top": cache["top"]}
    leaves = _flat(_as(cache, lambda t: t.clone().numpy()))
    return leaves + [v.clone().numpy() for v in eng.state.values()]


@pytest.mark.parametrize("layout", ["dense", "paged", "carry"])
def test_export_import_on_one_engine_changes_no_bit(fam, jax_streams,
                                                    layout):
    kind = LAYOUTS[layout][0]
    vocab = fam[kind][3].vocab_size
    eng = _port(fam, layout)
    for uid in (0, 1):
        eng.submit(_req(Request, uid, vocab))
    eng.step()
    eng.step()                                    # mid-decode
    assert len(_busy(eng)) == 2
    before = _snapshot(eng)
    bundle = eng.export_slots([0, 1])
    assert _busy(eng) == [] and not bool(eng.state["active"].any())
    assert eng.import_slots(bundle) == [0, 1]
    for i, (a, b) in enumerate(zip(before, _snapshot(eng))):
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
    got = {r.uid: r.generated for r in eng.run()}
    assert got == {u: jax_streams[kind][u] for u in (0, 1)}
    assert eng.stats["exported_slots"] == eng.stats["imported_slots"] == 2


@pytest.mark.parametrize("uid", [0, 1, 2], ids=["greedy", "T0.8", "T3"])
@pytest.mark.parametrize("src,dst", [("dense", "dense"), ("paged", "paged"),
                                     ("dense", "paged"), ("paged", "dense"),
                                     ("dense", "paged-small-pool"),
                                     ("carry", "carry")])
def test_migration_mid_decode_equals_the_uninterrupted_stream(
        fam, jax_streams, src, dst, uid):
    """A generation moved to another engine after two blocks (a busy
    neighbour on each side) emits the JAX engine's uninterrupted tokens;
    a paged import is a dense import."""
    kind = LAYOUTS[src][0]
    vocab = fam[kind][3].vocab_size
    a, b = _port(fam, src), _port(fam, dst)
    a.submit(_req(Request, uid, vocab))
    a.submit(_req(Request, 9, vocab, max_new=30))
    b.submit(_req(Request, 10, vocab, max_new=30))
    for _ in range(2):
        a.step()
        b.step()
    slot = next(i for i, s in enumerate(a.slots) if s and s.uid == uid)
    [d] = b.import_slots(a.export_slots([slot]))
    assert b.slots[d].uid == uid
    a.run()
    b.run()
    got = next(r.generated for r in b.finished if r.uid == uid)
    assert got == jax_streams[kind][uid]
    assert len(got) == 14


@pytest.mark.parametrize("layout", ["dense", "paged", "carry"])
@pytest.mark.parametrize("chunk", [4, 64])
def test_standby_promotion_equals_the_uninterrupted_stream(
        fam, jax_streams, layout, chunk):
    """Delta replication into another engine's standby store, `chunk`
    rows a sync, until the cursor reaches the source's pos; the source
    then dies and the standby is promoted: the tokens are the
    uninterrupted run's."""
    kind = LAYOUTS[layout][0]
    vocab = fam[kind][3].vocab_size
    a, b = _port(fam, layout), _port(fam, layout)
    reqs = [_req(Request, u, vocab) for u in (1, 2)]
    for r in reqs:
        a.submit(r)
    a.step()
    a.step()
    slots = {a.slots[s].uid: s for s in _busy(a)}
    kv = {u: len(r.prompt) + len(r.generated) - 1 for u, r in
          zip((1, 2), reqs)}
    cursor, syncs = {1: 0, 2: 0}, 0
    windowed = a.spec.windowed
    assert windowed == (kind == "kv")
    while any(cursor[u] < kv[u] for u in cursor) or syncs == 0:
        bundle = a.export_delta([(slots[u], cursor[u]) for u in (1, 2)],
                                chunk)
        b.standby_apply(bundle, [(0, 0), (1, 1)])
        cursor = {u: min(cursor[u] + chunk, kv[u]) if windowed else kv[u]
                  for u in cursor}
        syncs += 1
    assert syncs == (-(-max(kv.values()) // chunk) if windowed else 1)
    assert b.stats["standby_syncs"] == syncs
    np.testing.assert_array_equal(b.standby["cache"]["pos"][:2].numpy(),
                                  [kv[1], kv[2]])
    assert b.promote_standby([(0, reqs[0]), (1, reqs[1])]) == [0, 1]
    b.run()
    got = {r.uid: r.generated for r in b.finished}
    assert got == {u: jax_streams[kind][u] for u in (1, 2)}


def test_import_refuses_another_snapshot_max_len_or_a_full_engine(fam):
    jcfg, jfns, jparams, tcfg, tfns, tparams = fam["kv"]
    src = _port(fam, "dense")
    src.submit(_req(Request, 0, tcfg.vocab_size))
    src.step()
    bundle = src.export_slots(_busy(src))
    other = _port(fam, "dense")
    other.swap_params(tree_map(lambda x: x * 0.5, tparams))  # idle: now
    with pytest.raises(ValueError, match="snapshot"):
        other.import_slots(bundle)
    with pytest.raises(ValueError, match="snapshot"):
        other.standby_apply({**bundle, "starts": np.zeros(2, np.int32)},
                            [(0, 0)])
    with pytest.raises(ValueError, match="max_len"):
        _port(fam, "dense", max_len=32).import_slots(bundle)
    full = _port(fam, "dense", max_batch=1)
    full.submit(_req(Request, 1, tcfg.vocab_size))
    full.step()
    with pytest.raises(ValueError, match="free slots"):
        full.import_slots(bundle)
    with pytest.raises(ValueError, match="empty"):
        src.export_slots([0])
    with pytest.raises(ValueError, match="no standby"):
        src.promote_standby([(0, bundle["requests"][0])])


def test_paged_import_reserves_pages_and_frees_them_on_export(fam):
    """An import reserves every page the resumed generation can touch and
    refuses a pool that cannot hold it; an export hands them back."""
    vocab = fam["kv"][3].vocab_size
    a = _port(fam, "paged")
    a.submit(_req(Request, 0, vocab, max_new=40))
    a.step()
    bundle = a.export_slots(_busy(a))
    ps = a.page_stats()
    assert ps["host_free"] == ps["pool_pages"] and ps["device_live"] == 0
    tight = _port(fam, "paged", pool_pages=8, max_batch=3)
    for uid in (1, 2):                            # 4 pages reserved each
        tight.submit(_req(Request, uid, vocab, max_new=50))
    tight.step()
    with pytest.raises(ValueError, match="pages needed"):
        tight.import_slots(bundle)
    b = _port(fam, "paged")
    b.import_slots(bundle)
    assert b.stats["pages_reserved"] == 4          # ceil((10 + 40) / 16)
    live = b.page_stats()["device_live"]
    assert live == -(-(10 + len(bundle["requests"][0].generated) - 1) // 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "paged", "carry"])
def test_row_wire_bytes_and_kind_match_the_reference(layout, dtype):
    kind, lay = LAYOUTS[layout]
    arch = ARCHS[kind]
    jcfg = jreg.get_reduced_config(arch, compute_dtype=dtype)
    tcfg = treg.get_reduced_config(arch, compute_dtype=dtype)
    jspec, tspec = jds.decode_spec(jcfg), tds.decode_spec(tcfg, "cpu")
    if lay:
        kw = dict(page_size=16, max_batch=2, max_len=64)
        jspec, tspec = jds.paged_spec(jspec, **kw), tds.paged_spec(tspec,
                                                                   **kw)
    for max_len in (64, 200):
        assert tspec.row_wire_bytes(max_len) == \
            jspec.row_wire_bytes(max_len)
    assert tspec.windowed == jspec.windowed
    assert tspec.state_kind == jspec.state_kind
