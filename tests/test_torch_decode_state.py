"""The port's paged-KV allocator and state specs against the JAX package:
identical integer inputs give identical (bitwise) integer results; and
the reference's DecodeState protocol cases over the four families of
tests/test_decode_state.py (the demo LM, recurrentgemma, xLSTM, MoE),
the port's engines and planes against the JAX ones."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_state as jds  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import ConstellationRouter as JRouter  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ForcedOutage as JForcedOutage  # noqa: E402
from repro.serving import GridConfig as JGridConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models import decode_state as tds  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serving import (ConstellationRouter, EngineConfig,  # noqa: E402,E501
                                 ForcedOutage, GridConfig, Request,
                                 ServingEngine)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t_out, j_out):
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _allocator(seed, b=4, mp=6, pool=20):
    """A consistent allocator state: some rows hold pages, some pages are
    shared by two rows (refcount 2), the rest are on the free stack."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pool)
    used = perm[:8]
    ptab = np.full((b, mp), pool, np.int32)
    ptab[0, :3] = used[:3]
    ptab[1, :2] = used[:2]                  # shares two pages with row 0
    ptab[2, :4] = used[3:7]
    ref = np.zeros(pool + 1, np.int32)
    for p in ptab.ravel():
        if p != pool:
            ref[p] += 1
    free = np.zeros(pool, np.int32)
    stack = perm[7:]
    free[:len(stack)] = stack
    top = np.int32(len(stack))
    return ptab, free, top, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_rows_matches_reference(seed):
    ptab, free, top, ref = _allocator(seed)
    rng = np.random.default_rng(100 + seed)
    take = (ptab == 20) & (rng.random(ptab.shape) < 0.3)
    take[3, :2] = True
    j = jds._alloc_rows(jnp.asarray(ptab), jnp.asarray(free),
                        jnp.asarray(top), jnp.asarray(ref), jnp.asarray(take))
    t = tds._alloc_rows(_t(ptab), _t(free), _t(top), _t(ref), _t(take))
    _eq(t, j)


@pytest.mark.parametrize("drop", [[True, False, False, False],
                                  [True, True, False, False],
                                  [False, False, True, True],
                                  [True, True, True, True]])
def test_release_rows_matches_reference(drop):
    ptab, free, top, ref = _allocator(3)
    drop = np.array(drop)
    j = jds._release_rows(jnp.asarray(ptab), jnp.asarray(free),
                          jnp.asarray(top), jnp.asarray(ref),
                          jnp.asarray(drop))
    t = tds._release_rows(_t(ptab), _t(free), _t(top), _t(ref), _t(drop))
    _eq(t, j)


def test_gather_and_scatter_logical_match_reference():
    rng = np.random.default_rng(4)
    L, pool, ps, hkv, dh, b, mp = 2, 7, 4, 2, 8, 2, 3
    kp = rng.standard_normal((L, pool + 1, ps, hkv, dh), np.float32)
    ptab = np.array([[3, 1, 7], [0, 5, 6]], np.int32)
    np.testing.assert_array_equal(
        tds._gather_logical(_t(kp), _t(ptab)).numpy(),
        np.asarray(jds._gather_logical(jnp.asarray(kp), jnp.asarray(ptab))))
    vals = rng.standard_normal((L, b, mp * ps, hkv, dh), np.float32)
    write = np.zeros((b, mp * ps), bool)
    write[0, :6] = True
    write[1, 2:11] = True
    j = np.asarray(jds._scatter_logical(jnp.asarray(kp), jnp.asarray(ptab),
                                        jnp.asarray(vals),
                                        jnp.asarray(write)))
    t = tds._scatter_logical(_t(kp), _t(ptab), _t(vals), _t(write)).numpy()
    # every page but the trash page (the target of all unwritten
    # entries, in an unspecified order) is bitwise equal
    np.testing.assert_array_equal(t[:, :pool], j[:, :pool])


def test_admit_merge_matches_reference():
    rng = np.random.default_rng(5)
    state = {"k": rng.standard_normal((2, 3, 4), np.float32),
             "pos": np.arange(3, dtype=np.int32)}
    fresh = {"k": rng.standard_normal((2, 3, 4), np.float32),
             "pos": np.arange(3, dtype=np.int32) + 9}
    axes = {"k": 1, "pos": 0}
    admit = np.array([True, False, True])
    j = jds.admit_merge(jax.tree.map(jnp.asarray, state),
                        jax.tree.map(jnp.asarray, fresh), axes,
                        jnp.asarray(admit))
    t = tds.admit_merge({k: _t(v) for k, v in state.items()},
                        {k: _t(v) for k, v in fresh.items()}, axes,
                        _t(admit))
    for k in state:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def _specs(**kw):
    jcfg = jreg.get_reduced_config("suncatcher-lm-100m")
    tcfg = treg.get_reduced_config("suncatcher-lm-100m")
    j = jds.paged_spec(jds.decode_spec(jcfg), **kw)
    t = tds.paged_spec(tds.decode_spec(tcfg, "cpu"), **kw)
    return j, t


def test_paged_spec_geometry_and_advance_release_match_reference():
    j, t = _specs(page_size=16, max_batch=3, max_len=100, pool_pages=20,
                  prefix_entries=2)
    assert (t.padded_len, t.max_pages, t.pool_pages) == \
        (j.padded_len, j.max_pages, j.pool_pages)
    js, ts = j.init_state(3, 100), t.init_state(3, 100)
    assert set(js) == set(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
    active = np.array([True, True, False])
    for pos in ([0, 16, 5], [32, 17, 0]):
        js = {**js, "pos": jnp.asarray(pos, jnp.int32)}
        ts = {**ts, "pos": _t(np.array(pos, np.int32))}
        js = j.advance(js, jnp.asarray(active))
        ts = t.advance(ts, _t(active))
        for k in ("ptab", "ref", "top", "free"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    assert int(t.live_pages(ts)) == int(j.live_pages(js)) == 3
    drop = np.array([True, False, False])
    js, ts = j.release(js, jnp.asarray(drop)), t.release(ts, _t(drop))
    for k in ("ptab", "ref", "top", "free"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=48, max_batch=2, max_len=100), "must divide"),
    (dict(page_size=16, max_batch=2, max_len=256, pool_pages=8),
     "cannot hold"),
])
def test_paged_spec_rejects_bad_geometry(kw, match):
    cfg = treg.get_reduced_config("suncatcher-lm-100m")
    with pytest.raises(ValueError, match=match):
        tds.paged_spec(tds.decode_spec(cfg, "cpu"), **kw)


# --------------------------------------------------------------------------
# the four families of the reference's DecodeState protocol tests
# (tests/test_decode_state.py): the port's engine and plane against the
# JAX engine and plane on the same requests, f32 compute, the tied
# embedding scaled by 0.1 so that every token depends on the context
# --------------------------------------------------------------------------

ARCHS = ["suncatcher-lm-100m", "recurrentgemma-2b", "xlstm-350m",
         "qwen3-moe-30b-a3b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
_SETUP = {}


def _setup(arch):
    """(jax cfg, fns, params, port cfg, fns, params) of the reduced
    config at f32 compute, the same weights on both sides."""
    if arch not in _SETUP:
        jcfg = jreg.get_reduced_config(arch, compute_dtype="float32")
        tcfg = treg.get_reduced_config(arch, compute_dtype="float32")
        jfns, tfns = jreg.model_fns(jcfg), treg.model_fns(tcfg)
        jp = jfns.init(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "embed": jp["embed"] * 0.1}
        mod = {"TransformerConfig": "transformer", "RGLRUConfig": "rglru",
               "XLSTMConfig": "xlstm"}[type(tcfg).__name__]
        tp = __import__(f"repro_torch.models.{mod}",
                        fromlist=[mod]).params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _SETUP[arch] = (jcfg, jfns, jp, tcfg, tfns, tp)
    return _SETUP[arch]


def _ecfg(cls, **kw):
    base = dict(max_batch=2, max_len=64, decode_block=4)
    base.update(kw)
    return cls(**base)


def _reqs(cls, cfg, n=6, max_new=10, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(
        rng.integers(3, 24))).astype(np.int32), max_new_tokens=max_new,
        temperature=0.0 if i % 2 == 0 else 0.8) for i in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.generated for r in eng.run()}


_JAX_STREAMS = {}


def _jax_engine(arch, **kw):
    """The JAX engine's streams of the default workload (cached: its runs
    compile)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _JAX_STREAMS:
        jcfg, jfns, jp = _setup(arch)[:3]
        _JAX_STREAMS[key] = _serve(
            JServingEngine(jcfg, jfns, jp, _ecfg(JEngineConfig, **kw)),
            _reqs(JRequest, jcfg))
    return _JAX_STREAMS[key]


def _port_engine(arch, reqs=None, **kw):
    tcfg, tfns, tp = _setup(arch)[3:]
    return _serve(ServingEngine(tcfg, tfns, tp, _ecfg(EngineConfig, **kw)),
                  reqs or _reqs(Request, tcfg))


def test_decode_spec_kinds_and_windowed():
    kinds = {}
    for arch in ARCHS + MOE_ARCHS:
        jspec = jds.decode_spec(jreg.get_reduced_config(arch))
        tspec = tds.decode_spec(treg.get_reduced_config(arch), "cpu")
        kinds[arch] = (tspec.state_kind, tspec.windowed)
        assert kinds[arch] == (jspec.state_kind, jspec.windowed)
        assert type(tspec).__name__ == type(jspec).__name__
    assert kinds["suncatcher-lm-100m"] == ("kv", True)
    assert kinds["qwen3-moe-30b-a3b"] == ("kv+experts", True)
    assert kinds["granite-moe-1b-a400m"] == ("kv+experts", True)
    assert kinds["recurrentgemma-2b"] == ("carry", False)
    assert kinds["xlstm-350m"] == ("carry", False)
    for arch in MOE_ARCHS:
        kw = dict(page_size=16, max_batch=2, max_len=64)
        assert tds.paged_spec(tds.decode_spec(
            treg.get_reduced_config(arch), "cpu"), **kw).state_kind == \
            jds.paged_spec(jds.decode_spec(jreg.get_reduced_config(arch)),
                           **kw).state_kind == "kv+experts-paged"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_uniform_signature(arch):
    """Every family takes init_cache(cfg, batch, max_len, dtype=None) and
    builds the reference's tree: the same leaves, shapes and dtypes."""
    jcfg, jfns, _, tcfg, tfns, _ = _setup(arch)
    c1 = tfns.init_cache(tcfg, 2, 32, device="cpu")
    c2 = tfns.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    j = jfns.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    def sig(tree):       # (shape, dtype) leaf by leaf, dict keys sorted
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in sig(tree[k])]
        if isinstance(tree, tuple):
            return [x for v in tree for x in sig(v)]
        return [(tuple(tree.shape), str(tree.dtype).split(".")[-1])]
    assert sig(c2) == sig(j)
    assert [s for s, _ in sig(c1)] == [s for s, _ in sig(c2)]


@pytest.mark.parametrize("arch", ARCHS + ["granite-moe-1b-a400m"])
def test_fused_decode_bit_identical_to_per_token(arch):
    """decode_block 4 and 1 give identical tokens, greedy and sampled, and
    both equal the JAX engine's streams on the same requests."""
    fused = _port_engine(arch, decode_block=4)
    assert fused == _port_engine(arch, decode_block=1)
    assert fused == _jax_engine(arch, decode_block=4)
    assert all(len(g) == 10 for g in fused.values())
    assert sum(len(set(g)) for g in fused.values()) > 2 * len(fused)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layouts_match_reference_and_rows_couple_as_there(arch):
    """MoE routes every row of a call through one capacity-limited expert
    table, inactive rows and prefill pads included, so a request's
    tokens depend on its neighbours.  On 8 requests of 4-19 new tokens
    over 3 slots (rows go idle inside blocks), the port equals the JAX
    engine dense and paged, and the JAX plane under a chaos schedule; in
    both packages paged != dense and the plane != one engine alone
    (ROADMAP C7)."""
    def reqs(cls, cfg):
        rng = np.random.default_rng(0)
        return [cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(
            rng.integers(3, 24))).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 20)),
            temperature=0.0 if i % 2 == 0 else 0.8) for i in range(8)]

    kw = dict(max_batch=3, decode_block=4)
    got = {}
    for side, eng, ecls, router, outage, req, setup in (
            ("jax", JServingEngine, JEngineConfig, JRouter, JForcedOutage,
             JRequest, _setup(arch)[:3]),
            ("port", ServingEngine, EngineConfig, ConstellationRouter,
             ForcedOutage, Request, _setup(arch)[3:])):
        cfg, fns, p = setup
        for page in (0, 16):
            got[side, page] = _serve(eng(cfg, fns, p, _ecfg(
                ecls, page_size=page, **kw)), reqs(req, cfg))
        got[side, "plane"] = _serve(router(
            [eng(cfg, fns, p, _ecfg(ecls, **kw)) for _ in range(3)],
            forced_outage=outage(at_tick=2, pod=None)), reqs(req, cfg))
    for layout in (0, 16, "plane"):
        assert got["port", layout] == got["jax", layout], layout
    assert got["jax", 16] != got["jax", 0]
    assert got["jax", "plane"] != got["jax", 0]


def _greq(cls, cfg, uid, temp, max_new=12, plen=8):
    rng = np.random.default_rng(100 + uid)
    return cls(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                            size=plen).astype(np.int32),
               max_new_tokens=max_new, temperature=temp)


def _carry_plane(side, arch, replicate):
    """uids 1 and 2 both home on pod 1 of 3, which is struck at tick 2."""
    if side == "jax":
        cfg, fns, p = _setup(arch)[:3]
        eng, ecls, router, outage, grid, req = (
            JServingEngine, JEngineConfig, JRouter, JForcedOutage,
            JGridConfig, JRequest)
    else:
        cfg, fns, p = _setup(arch)[3:]
        eng, ecls, router, outage, grid, req = (
            ServingEngine, EngineConfig, ConstellationRouter, ForcedOutage,
            GridConfig, Request)
    plane = router([eng(cfg, fns, p, _ecfg(ecls)) for _ in range(3)],
                   forced_outage=outage(at_tick=2, pod=1),
                   grid=grid(replicate=replicate))
    reqs = [_greq(req, cfg, 1, 0.8), _greq(req, cfg, 2, 0.0)]
    return plane, reqs


def test_carry_pointer_flip_bit_identical():
    """xlstm-350m sessions on a struck pod are promoted from their warm
    standbys (whole-state syncs, fresh after the first) by pointer flips,
    and continue bit-identically to one engine serving them alone, and to
    the JAX plane."""
    arch = "xlstm-350m"
    plane, reqs = _carry_plane("port", arch, True)
    for r in reqs:
        plane.submit(r)
    plane.step()
    ps = plane.plane_stats()
    assert ps["standby_covered"] == 2 and ps["standby_fresh"] == 2
    done = plane.run()
    assert len(done) == 2 and all(r.done for r in done)
    assert plane.stats["pointer_flips"] == 2
    assert plane.stats["full_migrations"] == 0
    assert plane.stats["dropped_deferred"] == 0
    got = {r.uid: r.generated for r in done}
    alone = _port_engine(arch, [_greq(Request, _setup(arch)[3], u, t)
                                for u, t in ((1, 0.8), (2, 0.0))])
    assert got == alone
    jplane, jreqs = _carry_plane("jax", arch, True)
    assert got == _serve(jplane, jreqs)
    # a carry sync ships whole rows: every replicated row is charged its
    # row_wire_bytes
    full, per_pos, carry = plane.engines[0].spec.row_wire_bytes(64)
    ps = plane.plane_stats()
    assert per_pos == 0 and carry == full
    assert ps["replicated_bytes"] == full * ps["replicated_rows"] > 0


def test_carry_full_drain_bit_identical():
    """The replicate=False plane moves xlstm-350m carries bit-exactly
    through the generic export/import tree ops."""
    arch = "xlstm-350m"
    plane, reqs = _carry_plane("port", arch, False)
    done = _serve(plane, reqs)
    assert plane.stats["full_migrations"] >= 1
    assert plane.stats["pointer_flips"] == 0
    alone = _port_engine(arch, [_greq(Request, _setup(arch)[3], u, t)
                                for u, t in ((1, 0.8), (2, 0.0))])
    assert done == alone
    jplane, jreqs = _carry_plane("jax", arch, False)
    assert done == _serve(jplane, jreqs)
