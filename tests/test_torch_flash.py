"""The port's flash attention (kernel B3) against the JAX package, and the
model's dispatch to it.  On the CPU the port's wrapper runs its plain
version; the JAX kernel runs in Pallas interpret mode, as
tests/test_kernels.py runs it.  Inputs come from numpy seeds.

The reference wrapper zero-pads K/V to a multiple of 128 and its kernel
masks only the causal triangle, so non-causal attention at a length that
is not a multiple of 128 lets the padded keys into the softmax (max error
0.116 at S 100).  Non-causal cases therefore compare with the JAX kernel
only at multiples of 128 and with the JAX oracle elsewhere.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import attention_reference as j_oracle  # noqa: E402,E501
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402,E501
from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402,E501
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels.flash_attention.ref import tiled_attention_reference  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py's tolerances: f32 sums in another order (2e-5);
# bf16 outputs may round one ulp apart (2e-2, atol and rtol)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, b, h, hkv, s, dh, skv=None):
    """Head-major (B, H, S, dh) f32 numpy inputs."""
    rng = np.random.default_rng(seed)
    skv = skv or s
    return (rng.standard_normal((b, h, s, dh), np.float32),
            rng.standard_normal((b, hkv, skv, dh), np.float32),
            rng.standard_normal((b, hkv, skv, dh), np.float32))


def _both(arrs, dtype):
    """The same values as jax arrays and torch tensors of `dtype` (both
    round f32 to bf16 to nearest even)."""
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (1, 4, 4, 256, 64),     # MHA
    (2, 8, 2, 256, 128),    # GQA 4:1
    (1, 4, 1, 512, 64),     # MQA
    (1, 2, 2, 128, 256),    # wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel_at_the_sweep_shapes(b, h, hkv, s, dh, dtype,
                                                causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, b, h, hkv, s, dh), dtype)
    want = flash_attention_fwd(jq, jk, jv, causal=causal, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, layout="bhsd")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("s", [100, 200, 130])
def test_causal_unpadded_lengths_through_the_wrappers(s):
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(1, 2, 4, 2, s, 64))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)        # layout bshd
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,skv", [(100, 100), (200, 200), (64, 200)])
def test_non_causal_ragged_lengths_match_the_oracle(s, skv):
    """Where the reference wrapper's padding leaks into the softmax, the
    port masks keys >= Skv itself and agrees with the JAX oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 4, 2, s, 64, skv),
                                       "float32")
    want = j_oracle(jq, jk, jv, causal=False)
    got = flash_attention(tq, tk, tv, causal=False, layout="bhsd")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_causal_needs_equal_lengths():
    """A causal call's query rows are a slice of the keys' positions: Sq
    + q_offset <= Skv (Sq < Skv at offset 0 is a query slice's first
    rows, Sq == Skv the whole sequence)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 2, 8, 64, 16))
    match = re.escape("Sq + q_offset <= Skv")
    with pytest.raises(ValueError, match=match):
        flash_attention(k, q, q, causal=True, layout="bhsd")
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, causal=True, q_offset=9, layout="bhsd")
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, causal=True, q_offset=-1, layout="bhsd")


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax_grad_through_the_wrapper(causal):
    q, k, v = _qkv(4, 1, 4, 2, 128, 64)
    w = np.random.default_rng(5).standard_normal(q.shape, np.float32)

    def jloss(q_, k_, v_):
        out = j_flash(q_, k_, v_, causal=causal, layout="bhsd",
                      interpret=True)
        return jnp.sum(out * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, layout="bhsd")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, jg in zip(got, want):
        # both differentiate the f32 oracle; sums in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("hkv,s", [(1, 128), (2, 256), (4, 100)])
def test_output_rows_are_convex_combinations(hkv, s):
    """With V constant, every output row equals that constant."""
    q, k, _ = _qkv(s, 2, 4, hkv, s, 64)
    v = np.full_like(k, 3.25)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, layout="bhsd")
    np.testing.assert_allclose(out.numpy(), 3.25, atol=1e-5)


def test_plain_version_is_the_oracle():
    q, k, v = _qkv(6, 2, 4, 2, 48, 64)
    want = j_oracle(*map(jnp.asarray, (q, k, v)), causal=True)
    got = attention_reference(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------ the kernel's algorithm --

# the sweep shapes above, S 1000 and S 200 (not multiples of the 128-row
# tiles), MQA, head_dim 128
TILED_SHAPES = [
    (1, 4, 4, 256, 64),
    (2, 8, 2, 256, 128),
    (1, 4, 1, 512, 64),
    (1, 2, 2, 128, 256),
    (1, 4, 1, 1000, 64),
    (2, 4, 2, 200, 128),
]


@pytest.mark.parametrize("b,h,hkv,s,dh", TILED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_plain_version_matches_the_oracle(b, h, hkv, s, dh, dtype,
                                                causal):
    """The bf16 kernel's algorithm (tiles, skipped tiles above the
    diagonal, masks on the last tile only, exp2 with the folded scale, P
    rounded before P V) against the port's oracle on the same inputs.
    f32: 2e-5, sums in another order.  bf16: 2e-2 (atol and rtol, one
    output ulp; P rounded to bf16 moves each weight by at most 2**-9 of
    itself, the outputs by less than an ulp)."""
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in _qkv(9, b, h, hkv, s, dh))
    got = tiled_attention_reference(tq, tk, tv, causal=causal)
    want = attention_reference(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("b,h,hkv,s,dh,causal", [
    *((*shape, causal) for shape in TILED_SHAPES[:4]
      for causal in (True, False)),
    (1, 4, 1, 1000, 64, True),
    (2, 4, 2, 200, 128, True),
])
def test_tiled_plain_version_matches_the_jax_kernel(b, h, hkv, s, dh,
                                                    causal):
    """The same algorithm against the Pallas kernel in interpret mode, in
    f32 where the point is the algorithm (2e-5: sums in another order).
    At S 1000 and 200 the reference wrapper pads to its 128-row blocks,
    which only the causal mask keeps out of the softmax (module
    docstring), so the ragged lengths are causal here."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(10, b, h, hkv, s, dh),
                                       "float32")
    if s % 128:
        want = j_flash(jq, jk, jv, causal=causal, layout="bhsd",
                       interpret=True)
    else:
        want = flash_attention_fwd(jq, jk, jv, causal=causal,
                                   interpret=True)
    got = tiled_attention_reference(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["BQ", "BK"])
def test_tiled_plain_version_uses_the_kernels_tiles(name):
    """The plain version's BLOCK is the kernel's query and key tile."""
    src = fa_kernel.LIBRARY.source.read_text()
    assert int(re.search(rf"^constexpr int {name} = (\d+);", src,
                         re.M)[1]) == fa_ref.BLOCK


# ----------------------------------------------------------- dispatch ----

@pytest.fixture
def flash_calls(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return flash_attention(*a, **kw)
    monkeypatch.setattr(tl, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("case,to_flash", [
    (dict(), True),                                   # training forward
    (dict(causal=False), True),
    (dict(q_offset="tensor"), False),                 # a tensor offset
    (dict(q_offset=3), False),
    (dict(window=4), False),
    (dict(kv_len=6), False),
    (dict(skv=9), False),                             # Sq != Skv
    (dict(sq=1, skv=1), False),                       # one-row query
])
def test_dispatch_takes_flash_only_under_the_reference_condition(
        flash_calls, case, to_flash):
    """The reference's condition (src/repro/models/layers.py:249-257):
    q_offset a Python int 0, no window, no kv_len, Sq == Skv; a one-row
    query takes the decode branch first.  Either way the output is the
    reference's attention_ref."""
    case = dict(case)
    sq, skv = case.pop("sq", 6), case.pop("skv", 6)
    if case.get("q_offset") == "tensor":
        case["q_offset"] = 0
        tq_off = torch.tensor(0)
    else:
        tq_off = case.get("q_offset", 0)
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(7, 2, 4, 2, sq, 16,
                                                     skv))
    kw = {n: case[n] for n in ("causal", "window", "kv_len") if n in case}
    got = tl.attention(*map(torch.from_numpy, (q, k, v)), q_offset=tq_off,
                       **kw)
    want = jl.attention_ref(q, k, v, q_offset=case.get("q_offset", 0), **kw)
    assert len(flash_calls) == int(to_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_model_forward_flashes_and_serving_does_not(flash_calls):
    """forward sends every block to flash; the engine's ragged prefill
    (per-row q_offset) and decode (kv_len) calls do not."""
    cfg = treg.get_reduced_config("suncatcher-lm-100m",
                                  compute_dtype="float32")
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 10)))
    with torch.no_grad():
        logits = ttf.forward(params, toks, cfg)
        assert flash_calls == [True] * cfg.n_layers
        cache = ttf.init_cache(cfg, 2, 32, device="cpu")
        cache["pos"] = torch.zeros(2, dtype=torch.int32)
        pre, cache = ttf.decode_step(params, cache, toks, cfg,
                                     last_idx=torch.tensor([9, 9]))
        ttf.decode_step(params, cache, toks[:, :1], cfg)
    assert len(flash_calls) == cfg.n_layers
    np.testing.assert_allclose(pre.numpy(), logits[:, -1].numpy(),
                               atol=1e-4, rtol=1e-4)
