"""The port's RG-LRU scan (kernel B4's plain version and its autograd
wrapper, which run for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its oracles, at `TestRGLRUScan`'s sweep
shapes; inputs from numpy seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan import rglru_scan as jscan  # noqa: E402
from repro.kernels.rglru_scan import (  # noqa: E402
    rglru_scan_associative, rglru_scan_reference as jref)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_backward_reference, rglru_scan_reference)

torch.set_num_threads(1)

# tests/test_kernels.py::_tol x 5, as TestRGLRUScan holds the Pallas kernel
TOL = {"float32": 2e-5 * 5, "bfloat16": 2e-2 * 5}


def _inputs(b, s, d, dtype, seed, lo=0.2, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ja, jx = jnp.asarray(a, jdt), jnp.asarray(x, jdt)
    tdt = getattr(torch, dtype)
    # the same (rounded) values on both sides
    return ja, jx, (torch.from_numpy(np.array(ja, np.float32)).to(tdt),
                    torch.from_numpy(np.array(jx, np.float32)).to(tdt))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("b,s,d", [(2, 256, 128), (1, 512, 256),
                                   (3, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_matches_pallas_kernel_and_oracle(b, s, d, dtype):
    ja, jx, (a, x) = _inputs(b, s, d, dtype, seed=b * s + d)
    got = rglru_scan(a, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = TOL[dtype]
    want = np.asarray(jscan(ja, jx, interpret=True), np.float32)
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
    # the JAX sequential oracle computes the same two roundings per step
    np.testing.assert_allclose(_np(got), np.asarray(jref(ja, jx), np.float32),
                               atol=tol, rtol=tol)
    assert torch.equal(got, rglru_scan_reference(a, x))


def test_unpadded_shape_without_padding():
    """(2, 100, 70): the JAX wrapper pads to 256 x 128 blocks; the port
    takes the shape as it is."""
    ja, jx, (a, x) = _inputs(2, 100, 70, "float32", seed=7, lo=0.5, hi=0.99)
    got = rglru_scan(a, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jscan(
        ja, jx, interpret=True)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        rglru_scan_associative(ja, jx)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero_a_is_identity_and_one_a_is_cumsum(seed):
    """a == 0 -> h == x; a == 1 -> h == cumsum(x) (integer-valued x: every
    partial sum is exact in f32, so the cumsum is bitwise)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 128, 128)).astype(
        np.float32))
    assert torch.equal(rglru_scan(torch.zeros_like(x), x), x)
    xi = torch.from_numpy(rng.integers(-8, 9, (1, 128, 128)).astype(
        np.float32))
    assert torch.equal(rglru_scan(torch.ones_like(xi), xi),
                       torch.cumsum(xi, dim=1))
    h1 = np.asarray(jscan(jnp.ones((1, 128, 128)), jnp.asarray(x.numpy()),
                          interpret=True))
    np.testing.assert_allclose(rglru_scan(torch.ones_like(x), x).numpy(), h1,
                               atol=1e-4, rtol=1e-4)


def test_gradients_match_jax_grad():
    """The backward is the VJP of the plain recurrence: gradients of a
    and x equal jax.grad through the Pallas wrapper (whose custom_vjp
    differentiates the associative oracle) within 1e-5."""
    ja, jx, (a, x) = _inputs(1, 128, 128, "float32", seed=9, lo=0.5,
                             hi=0.99)
    rng = np.random.default_rng(10)
    g = rng.standard_normal((1, 128, 128)).astype(np.float32)

    def jloss(a_, x_):
        return jnp.sum(jscan(a_, x_, interpret=True) * g)
    jga, jgx = jax.grad(jloss, argnums=(0, 1))(ja, jx)
    a.requires_grad_()
    x.requires_grad_()
    ga, gx = torch.autograd.grad((rglru_scan(a, x) * torch.from_numpy(g))
                                 .sum(), (a, x))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("b,s,d", [(2, 33, 7), (1, 1, 5), (3, 100, 70),
                                   (2, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_reference_is_autograd_through_the_formula_bitwise(
        b, s, d, dtype):
    """The plain reverse walk equals autograd's VJP through the
    sequential formula bit for bit, signed zeros included: da_0 =
    dh_0 * 0.0 is -0.0 wherever dh_0 < 0; bf16 a, x and g widen exactly
    and the gradients round once.  So does the autograd wrapper, whose
    backward runs the walk for CPU tensors."""
    _, _, (a, x) = _inputs(b, s, d, dtype, seed=b * s + d)
    g = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, d)).astype(np.float32)).to(a.dtype)
    a.requires_grad_()
    x.requires_grad_()
    want = torch.autograd.grad(rglru_scan_reference(a, x), (a, x), g)
    h = rglru_scan_reference(a.detach().float(), x.detach().float())
    got = rglru_scan_backward_reference(a.detach(), h, g)
    wrapped = torch.autograd.grad(rglru_scan(a, x), (a, x), g)
    for u, v, w in zip(got, wrapped, want):
        assert u.dtype == w.dtype == getattr(torch, dtype)
        assert torch.equal(_bits(u), _bits(w))
        assert torch.equal(_bits(v), _bits(w))
    dh0 = got[1][:, 0].float()
    assert torch.equal(torch.signbit(got[0][:, 0]), dh0 < 0)
    assert bool((got[0][:, 0] == 0).all()) and bool((dh0 < 0).any())


def test_backward_reference_matches_jax_grad():
    """The plain reverse walk against jax.grad through the Pallas
    wrapper (the VJP of the associative oracle) within 1e-5, as
    test_gradients_match_jax_grad holds the wrapper."""
    ja, jx, (a, x) = _inputs(2, 200, 96, "float32", seed=21, lo=0.5,
                             hi=0.99)
    g = np.random.default_rng(22).standard_normal((2, 200, 96)).astype(
        np.float32)

    def jloss(a_, x_):
        return jnp.sum(jscan(a_, x_, interpret=True) * g)
    jga, jgx = jax.grad(jloss, argnums=(0, 1))(ja, jx)
    da, dx = rglru_scan_backward_reference(a, rglru_scan_reference(a, x),
                                           torch.from_numpy(g))
    np.testing.assert_allclose(da.numpy(), np.asarray(jga), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)


def test_forward_saves_the_f32_carry_only_where_a_gradient_is_wanted():
    """bf16 x under autograd: the output is the f32 carry rounded once
    (the same bits as without autograd), and the saved carry is the
    unrounded f32 one the backward needs."""
    _, _, (a, x) = _inputs(1, 64, 32, "bfloat16", seed=3)
    plain = rglru_scan(a, x)
    a.requires_grad_()
    out = rglru_scan(a, x)
    assert out.dtype == torch.bfloat16 and torch.equal(out, plain)
    saved = out.grad_fn.saved_tensors
    assert saved[1].dtype == torch.float32
    assert torch.equal(saved[1], rglru_scan_reference(a.detach().float(),
                                                      x.float()))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(a, a)
    with pytest.raises(TypeError, match="float32 or"):
        rglru_scan_fwd(a.half(), a.half())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan_fwd(a, torch.ones(1, 4, 9))


def test_backward_wrapper_refuses_what_the_kernel_cannot_take():
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(a, a, a)
    with pytest.raises(TypeError, match="float32 or"):
        rglru_scan_bwd(a.half(), a, a.half())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan_bwd(a, a, torch.ones(1, 5, 8))


@pytest.mark.parametrize("d,dtype,off,path", [
    (2560, torch.float32, 0, "tma"),
    (2600, torch.bfloat16, 0, "tma"),      # 5200-byte rows
    (70, torch.float32, 0, "cp.async"),    # 280-byte rows
    (2560, torch.float32, 1, "cp.async"),  # bases 4 bytes off
    (77, torch.bfloat16, 0, "cp.async"),
    (2560, torch.bfloat16, 8, "tma"),      # 16 bytes off: aligned again
])
def test_copy_path_follows_the_tma_rule(d, dtype, off, path):
    """The kernel's ring is filled by TMA where rows are whole 16-byte
    units and both bases are 16-byte aligned, by cp.async else; the
    choice reads only shapes and addresses, so it is the same here."""
    from repro_torch.kernels.rglru_scan.kernel import copy_path
    buf = torch.zeros(2 * 3 * d + off + 64, dtype=dtype)
    base = (-buf.data_ptr() % 16) // buf.element_size()   # 16-byte start
    a = buf[base + off:base + off + 2 * 3 * d].view(2, 3, d)
    x = torch.zeros(2, 3, d, dtype=dtype)
    assert x.data_ptr() % 16 == 0
    assert copy_path(a, x) == path
    # the backward's a, h (an f32 carry) and g: one misaligned base is
    # enough for cp.async
    h = torch.zeros(2, 3, d)
    if dtype == torch.float32:
        assert copy_path(a, h, x) == path
        assert copy_path(x, h, a) == path
