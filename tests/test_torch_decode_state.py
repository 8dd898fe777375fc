"""The port's paged-KV allocator and state specs against the JAX package:
identical integer inputs give identical (bitwise) integer results."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_state as jds  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import decode_state as tds  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

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
