"""The port's threefry PRNG against `jax.random` (default threefry2x32,
partitionable): keys and raw bits bitwise, categorical draws token for
token."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.serving import prng  # noqa: E402

torch.set_num_threads(1)


def test_jax_runs_the_configuration_the_port_reproduces():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_seeds_jax_would_truncate():
    with pytest.raises(ValueError, match="seed"):
        prng.PRNGKey(2**32)


def _keys(seed, n):
    base = jax.random.PRNGKey(seed)
    data = np.random.default_rng(seed).integers(0, 2**31 - 1, n)
    data[:3] = [0, 1, 2**31 - 1][:n]
    return base, data.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3])
def test_fold_in_and_split_bitwise(seed):
    base, data = _keys(seed, 16)
    jf = np.asarray(jax.vmap(lambda d: jax.random.fold_in(base, d))(data))
    tf = prng.fold_in(prng.PRNGKey(seed).expand(16, 2), torch.from_numpy(data))
    np.testing.assert_array_equal(tf.numpy(), jf)
    for num in (2, 3):
        js = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jf))
        np.testing.assert_array_equal(prng.split(tf, num).numpy(), js)


def test_raw_bits_and_uniform_bitwise():
    base, data = _keys(1, 8)
    keys = jax.vmap(lambda d: jax.random.fold_in(base, d))(data)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    # dtypes pinned: other test modules turn on jax_enable_x64, under
    # which jax's defaults become 64-bit draws
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (50,), jnp.uint32))(keys))
    np.testing.assert_array_equal(prng.random_bits(tkeys, 50).numpy(), jb)
    tiny = np.finfo(np.float32).tiny
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (50,), jnp.float32, minval=tiny, maxval=1.0))(keys))
    np.testing.assert_array_equal(prng.uniform(tkeys, 50).numpy(), ju)


@pytest.mark.parametrize("scale", [0.5, 3.0, 20.0])
def test_categorical_tokens_equal(scale):
    """The engine's draw: categorical over top-k logits / temperature.
    (log is computed by each framework's own math library, so the gumbel
    noise may differ in the last ulp; the drawn tokens do not.)"""
    base, data = _keys(2, 64)
    keys = jax.vmap(lambda d: jax.random.fold_in(base, d))(data)
    logits = (np.random.default_rng(9).standard_normal((64, 50))
              * scale).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
