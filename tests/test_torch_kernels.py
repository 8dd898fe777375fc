"""The port's decode-attention kernels (B1 dense, B2 paged) against the
JAX package: the plain PyTorch versions (what the wrappers run for CPU
tensors) vs the Pallas kernels in interpret mode and vs the jnp oracles;
paged vs dense and trash-page poison, bitwise; the plain spelling of the
CUDA kernels' split-K algorithm against both.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jax_decode_attention,
    decode_attention_reference as jax_decode_ref,
    paged_decode_attention as jax_paged_decode_attention,
    paged_decode_attention_reference as jax_paged_ref)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_reference, gather_pages,
    paged_decode_attention, paged_decode_attention_reference,
    paged_split_decode_attention_reference, split_decode_attention_reference)
from repro_torch.kernels.decode_attention import kernel  # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py's tolerances: f32 2e-5; bf16 2e-2 (one bf16 ulp
# at the outputs' magnitude, where the two sides round differently)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _jx(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _dense_case(seed, b, h, hkv, m, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, dh), np.float32),
            rng.standard_normal((b, m, hkv, dh), np.float32),
            rng.standard_normal((b, m, hkv, dh), np.float32))


def _paged_case(seed, b, h, hkv, ps, mp, dh, pool_pages, lens):
    """Random pool, a permuted page table, entries past each row's last
    live page mapped to the trash page (id pool_pages)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh), np.float32)
    kp = rng.standard_normal((pool_pages + 1, ps, hkv, dh), np.float32)
    vp = rng.standard_normal((pool_pages + 1, ps, hkv, dh), np.float32)
    ptab = rng.permutation(pool_pages)[:b * mp].reshape(b, mp)
    live = -(-np.asarray(lens) // ps)
    ptab = np.where(np.arange(mp)[None] < live[:, None], ptab, pool_pages)
    return q, kp, vp, ptab.astype(np.int32)


# (b, h, hkv, m, dh): MHA, GQA, MQA; M not a multiple of 32 or 128
DENSE = [(2, 4, 4, 200, 64), (3, 6, 2, 256, 128), (2, 4, 1, 100, 64)]


@pytest.mark.parametrize("b,h,hkv,m,dh", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_plain_matches_jax_kernel_and_oracle(b, h, hkv, m, dh, dtype):
    q, k, v = _dense_case(1, b, h, hkv, m, dh)
    lens = np.array([0, m, m // 2 + 7][:b], np.int32)   # ragged, incl. 0
    got = decode_attention(_t(q, dtype)[:, None], _t(k, dtype),
                           _t(v, dtype), torch.from_numpy(lens))[:, 0]
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    jq, jk, jv = _jx(q, dtype), _jx(k, dtype), _jx(v, dtype)
    kern = jax_decode_attention(jq[:, None], jk, jv, jnp.asarray(lens),
                                interpret=True)[:, 0]
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(lens))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _np(oracle), atol=tol, rtol=tol)
    assert np.all(got[0] == 0.0)                         # kv_len == 0 row


def test_dense_scalar_kv_len_and_rank3_query():
    q, k, v = _dense_case(2, 2, 4, 2, 96, 64)
    got = decode_attention(_t(q, "float32"), _t(k, "float32"),
                           _t(v, "float32"), 40)
    ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=2e-5, rtol=2e-5)
    assert got.shape == (2, 4, 64)


def test_dense_tail_past_kv_len_never_matters():
    q, k, v = _dense_case(3, 2, 4, 2, 128, 64)
    lens = torch.tensor([33, 100], dtype=torch.int32)
    a = decode_attention_reference(_t(q, "float32"), _t(k, "float32"),
                                   _t(v, "float32"), lens)
    k[0, 33:], v[0, 33:], k[1, 100:], v[1, 100:] = 1e4, -1e4, 1e4, -1e4
    b = decode_attention_reference(_t(q, "float32"), _t(k, "float32"),
                                   _t(v, "float32"), lens)
    assert torch.equal(a, b)


# (b, h, hkv, ps, mp, dh)
PAGED = [(2, 4, 4, 16, 8, 64), (3, 6, 2, 32, 4, 128), (2, 4, 1, 64, 3, 64)]


@pytest.mark.parametrize("b,h,hkv,ps,mp,dh", PAGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax_kernel_and_oracle(b, h, hkv, ps, mp, dh,
                                                   dtype):
    lens = np.array([ps * mp - 1, 0, ps + 3][:b], np.int32)
    q, kp, vp, ptab = _paged_case(4, b, h, hkv, ps, mp, dh, b * mp + 3,
                                  lens)
    got = paged_decode_attention(_t(q, dtype)[:, None], _t(kp, dtype),
                                 _t(vp, dtype), torch.from_numpy(ptab),
                                 torch.from_numpy(lens))[:, 0]
    got = got.float().numpy()
    jq, jk, jv = _jx(q, dtype), _jx(kp, dtype), _jx(vp, dtype)
    kern = jax_paged_decode_attention(jq[:, None], jk, jv,
                                      jnp.asarray(ptab), jnp.asarray(lens),
                                      interpret=True)[:, 0]
    oracle = jax_paged_ref(jq, jk, jv, jnp.asarray(ptab), jnp.asarray(lens))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _np(oracle), atol=tol, rtol=tol)
    assert np.all(got[1] == 0.0)                         # kv_len == 0 row


def test_paged_equals_dense_on_same_logical_cache():
    b, h, hkv, ps, mp, dh = 3, 4, 2, 16, 6, 64
    lens = np.array([ps * 2 + 5, ps * mp, 1], np.int32)
    q, kp, vp, ptab = _paged_case(5, b, h, hkv, ps, mp, dh, 24, lens)
    tq, tk, tv = (_t(x, "float32") for x in (q, kp, vp))
    tab, tl = torch.from_numpy(ptab), torch.from_numpy(lens)
    paged = paged_decode_attention(tq, tk, tv, tab, tl)
    dense = decode_attention(tq, gather_pages(tk, tab), gather_pages(tv, tab),
                             tl)
    assert torch.equal(paged, dense)


def test_trash_page_poison_is_bitwise_invariant():
    b, h, hkv, ps, mp, dh, pool = 2, 4, 2, 16, 6, 64, 24
    lens = np.array([ps * 2 + 5, ps * mp - 2], np.int32)
    q, kp, vp, ptab = _paged_case(6, b, h, hkv, ps, mp, dh, pool, lens)
    args = (torch.from_numpy(ptab), torch.from_numpy(lens))
    out1 = paged_decode_attention_reference(_t(q, "float32"),
                                            _t(kp, "float32"),
                                            _t(vp, "float32"), *args)
    unref = np.ones(pool + 1, bool)
    unref[ptab.ravel()] = False
    unref[pool] = True
    kp[unref], vp[unref] = 1e4, -1e4
    out2 = paged_decode_attention_reference(_t(q, "float32"),
                                            _t(kp, "float32"),
                                            _t(vp, "float32"), *args)
    assert torch.equal(out1, out2)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((9, 4, 2, 8), np.float32)
    ptab = rng.integers(0, 9, (3, 5)).astype(np.int32)
    from repro.kernels.decode_attention import gather_pages as jax_gather
    np.testing.assert_array_equal(
        gather_pages(torch.from_numpy(pool), torch.from_numpy(ptab)).numpy(),
        np.asarray(jax_gather(jnp.asarray(pool), jnp.asarray(ptab))))


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v = _dense_case(8, 2, 4, 2, 64, 64)
    before = (decode_attention.launches, paged_decode_attention.launches)
    decode_attention(_t(q, "float32"), _t(k, "float32"), _t(v, "float32"),
                     5)
    assert (decode_attention.launches,
            paged_decode_attention.launches) == before


@pytest.mark.parametrize("bad,match", [("dtype", "float32 or bfloat16"),
                                       ("head_dim", "head_dim"),
                                       ("device", "needs CUDA tensors")])
def test_kernel_launcher_rejects_what_it_cannot_take(bad, match):
    """The launcher validates before it builds or launches anything."""
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 32, 2, 64)
    lens = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        # no instance at 96; a head dim below 64 is padded, not refused
        q, k = torch.zeros(2, 4, 96), torch.zeros(2, 32, 2, 96)
    with pytest.raises((TypeError, ValueError), match=match):
        kernel.decode_attention_fwd(q, k, k, lens)


# (dh, chunk): the CUDA source's chunk at every head dim it compiles,
# chunk 128, and a small chunk that makes many splits
SPLIT = [(64, 64), (64, 128), (128, 64), (128, 128), (160, 64), (256, 64),
         (64, 16)]


def test_split_cases_cover_the_kernel_instances():
    """The source fixes one chunk for every instance; the cases below
    hold the plain split-K algorithm at that chunk for each head dim."""
    src = kernel.LIBRARY.source.read_text()
    chunks = re.findall(r"^constexpr int C = (\d+);", src, re.M)
    assert len(chunks) == 1
    assert {(dh, int(chunks[0])) for dh in kernel._HEAD_DIMS} <= set(SPLIT)


@pytest.mark.parametrize("dh,chunk", SPLIT)
def test_split_plain_matches_oracle_and_jax_kernel(dh, chunk):
    """kv_len 0, 1, C-1, C, C+1 and the full cap (three splits, the last
    ragged), GQA 6/2, f32: within 2e-5 of the Pallas kernel (interpret
    mode) and of the oracle (the splits sum in another order)."""
    b, h, hkv = 6, 6, 2
    m = 2 * chunk + 40
    q, k, v = _dense_case(9, b, h, hkv, m, dh)
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, m], np.int32)
    got = split_decode_attention_reference(
        _t(q, "float32"), _t(k, "float32"), _t(v, "float32"),
        torch.from_numpy(lens), chunk).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = jax_decode_attention(jq[:, None], jk, jv, jnp.asarray(lens),
                                interpret=True)[:, 0]
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(got, _np(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, _np(oracle), atol=2e-5, rtol=2e-5)
    assert np.all(got[0] == 0.0)                         # kv_len == 0 row


@pytest.mark.parametrize("ps", [16, 64])
def test_split_plain_paged_equals_dense_bitwise(ps):
    """The paged form reads each position through the page table; with
    NaN in every pool page no live position maps to (the trash page
    included) it equals the dense form on the gathered cache bitwise, and
    both equal the dense form on a cache zeroed past kv_len."""
    b, h, hkv, dh, chunk = 4, 4, 2, 64, 64
    mp = 256 // ps
    pool = b * mp + 3
    lens = np.array([0, 1, 130, 256], np.int32)
    q, kp, vp, ptab = _paged_case(10, b, h, hkv, ps, mp, dh, pool, lens)
    unref = np.ones(pool + 1, bool)
    live = np.arange(mp)[None] < (-(-lens // ps))[:, None]
    unref[ptab[live]] = False
    kp[unref], vp[unref] = np.nan, np.nan
    tq, tk, tv = (_t(x, "float32") for x in (q, kp, vp))
    tab, tl = torch.from_numpy(ptab), torch.from_numpy(lens)
    paged = paged_split_decode_attention_reference(tq, tk, tv, tab, tl,
                                                   chunk)
    kd, vd = gather_pages(tk, tab), gather_pages(tv, tab)
    dense = split_decode_attention_reference(tq, kd, vd, tl, chunk)
    assert torch.equal(paged, dense) and bool(torch.isfinite(paged).all())
    keep = (torch.arange(mp * ps)[None] < tl[:, None])[:, :, None, None]
    clean = split_decode_attention_reference(
        tq, torch.where(keep, kd, 0.0), torch.where(keep, vd, 0.0), tl, chunk)
    assert torch.equal(paged, clean)
