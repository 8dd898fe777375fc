"""The port's SDC injector (`repro_torch.core.radiation.injection`)
against the JAX package's: the same key flips the same bits.

- `flip_bits` bitwise for float32, bfloat16 and float16 (the reference
  with jax's default 32-bit types, as its launcher runs it: int32 draws)
  and float64 (under jax_enable_x64, which float64 needs: int64 draws);
  many flips on a tensor of a few elements, where draws collide and the
  reference keeps each element's last draw.
- `inject_tree` over a nested tree whose insertion order is not sorted:
  the leaf counts go to the leaves `jax.tree.flatten` orders.
- `SDCInjector` events and trees for one seed over several steps.
- `count_changed_elements` compares bit patterns (a flip to a denormal
  counts).
Each test sets jax's precision itself: other modules turn x64 on
process-wide."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.radiation import RadiationEnvironment as JEnv  # noqa: E402
from repro.core.radiation import injection as jinj  # noqa: E402
from repro_torch.core.radiation import RadiationEnvironment  # noqa: E402
from repro_torch.core.radiation import injection as tinj  # noqa: E402
from repro_torch.serving import prng  # noqa: E402

torch.set_num_threads(1)

_NP = {"float32": np.float32, "float16": np.float16,
       "bfloat16": ml_dtypes.bfloat16, "float64": np.float64}
_VIEW = {"float32": np.uint32, "float16": np.uint16, "bfloat16": np.uint16,
         "float64": np.uint64}


def _values(dtype, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    x.flat[0] = 0.0                    # a flip here may make a denormal
    return x.astype(_NP[dtype])


def _t(a):
    """numpy (bfloat16 included) -> torch, bits kept."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """torch -> numpy unsigned bit patterns."""
    view = {torch.float32: np.uint32, torch.float64: np.uint64}
    if t.dtype in view:
        return t.numpy().view(view[t.dtype])
    return t.view(torch.int16).numpy().view(np.uint16)


def _jflip(seed, x, n):
    with jax.enable_x64(x.dtype == np.float64):
        return np.asarray(jinj.flip_bits(jax.random.PRNGKey(seed),
                                         jnp.asarray(x), n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
@pytest.mark.parametrize("shape,n,seed", [((5,), 1, 0), ((3,), 40, 1),
                                          ((4, 33), 7, 2), ((2,), 64, 3)])
def test_flip_bits_matches_jax_bitwise(dtype, shape, n, seed):
    x = _values(dtype, shape, seed)
    want = _jflip(seed, x, n).view(_VIEW[dtype])
    got = tinj.flip_bits(prng.PRNGKey(seed), _t(x), n)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_array_equal(_bits(got), want)
    assert not np.array_equal(want, x.view(_VIEW[dtype]))


def test_duplicate_draws_keep_each_elements_last_flip():
    """40 draws on 3 elements: the reference's scatter gathers the
    original bits for every draw and keeps the last write, so each hit
    element differs from x by exactly its last draw's bit."""
    x = _values("float32", (3,), 5)
    with jax.enable_x64(False):
        ki, kb = jax.random.split(jax.random.PRNGKey(5))
        idx = np.asarray(jax.random.randint(ki, (40,), 0, 3))
        bit = np.asarray(jax.random.randint(kb, (40,), 0, 32))
    assert len(set(idx.tolist())) < 40          # draws collide
    want = x.view(np.uint32).copy()
    for i in set(idx.tolist()):
        last = np.nonzero(idx == i)[0][-1]
        want[i] ^= np.uint32(1) << np.uint32(bit[last])
    got = tinj.flip_bits(prng.PRNGKey(5), _t(x), 40)
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_jflip(5, x, 40).view(np.uint32), want)


def test_flip_bits_leaves_its_input_and_zero_flips_alone():
    x = _t(_values("float32", (6,), 0))
    before = x.clone()
    assert tinj.flip_bits(prng.PRNGKey(0), x, 0) is x
    tinj.flip_bits(prng.PRNGKey(0), x, 5)
    assert torch.equal(x, before)


def _tree(seed):
    """A nested tree in unsorted insertion order, mixed dtypes, an int
    leaf (never flipped)."""
    rng = np.random.default_rng(seed)
    return {"zeta": rng.standard_normal((4, 8)).astype(np.float32),
            "alpha": {"w": rng.standard_normal((16,)).astype(np.float32),
                      "b": rng.standard_normal((3, 5)).astype(
                          ml_dtypes.bfloat16)},
            "step": np.array([7], np.int32),
            "mid": {"y": rng.standard_normal((2, 9)).astype(np.float16),
                    "x": rng.standard_normal((40,)).astype(np.float32)}}


def _ttree(tree):
    return {k: _ttree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _assert_trees_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_bitwise(got[k], want[k])
        elif want[k].dtype == np.int32:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            np.testing.assert_array_equal(
                _bits(got[k]), np.asarray(want[k]).view(
                    _VIEW[str(np.asarray(want[k]).dtype)]))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 6), (2, 50)])
def test_inject_tree_matches_jax_in_sorted_leaf_order(seed, n):
    tree = _tree(seed)
    with jax.enable_x64(False):
        jt = jax.tree.map(jnp.asarray, tree)
        want = jinj.inject_tree(jax.random.PRNGKey(seed), jt, n)
        want = {k: (jax.tree.map(np.asarray, v)) for k, v in want.items()}
    got = tinj.inject_tree(prng.PRNGKey(seed), _ttree(tree), n)
    assert list(got) == list(tree)          # the port keeps insertion order
    _assert_trees_bitwise(got, want)
    changed = sum(tinj.count_changed_elements(a, b) for a, b in zip(
        _leaves(got), _leaves(_ttree(tree))) if a.is_floating_point())
    assert 1 <= changed <= n


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def test_injector_events_and_trees_match_jax_for_one_seed():
    """A rate high enough for several events a step: the Poisson counts,
    the running key and the corrupted trees equal the reference's over 6
    steps, one of them forced."""
    kw = dict(n_chips=81 * 256, step_time_s=1.0, seed=11,
              rate_multiplier=1e3)
    tree = _tree(4)
    with jax.enable_x64(False):
        jinjector = jinj.SDCInjector(JEnv(), **kw)
        jt = jax.tree.map(jnp.asarray, tree)
        want = []
        for step in range(6):
            jt, n = jinjector.maybe_inject(
                jt, forced_events=3 if step == 4 else None)
            want.append((n, {k: jax.tree.map(np.asarray, jt[k])
                             for k in tree}))
    injector = tinj.SDCInjector(RadiationEnvironment(), **kw)
    assert injector.expected_per_step() == jinjector.expected_per_step()
    tt = _ttree(tree)
    for step in range(6):
        tt, n = injector.maybe_inject(tt, forced_events=3 if step == 4
                                      else None)
        assert n == want[step][0]
        _assert_trees_bitwise(tt, want[step][1])
    assert injector.events_injected == jinjector.events_injected > 3
    np.testing.assert_array_equal(injector.key.numpy(),
                                  np.asarray(jinjector.key))


def test_count_changed_elements_sees_a_flip_to_a_denormal():
    for dtype in ("float32", "bfloat16", "float16", "float64"):
        a = torch.zeros(4, dtype=getattr(torch, dtype))
        b = a.clone()
        view = tinj._BITS_FOR[a.dtype][0]
        b.view(view)[2] = 1                     # the smallest denormal
        assert tinj.count_changed_elements(a, b) == 1
        assert tinj.count_changed_elements(a, a.clone()) == 0
