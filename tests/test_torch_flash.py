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


# --------------------------------------------- the bf16 kernel's order ----

MIB = 1 << 20
H100_L2 = 50 * MIB          # torch.cuda.get_device_properties().L2_cache_size

# (B, H, Hkv, Sq, Skv, causal, q_offset): the chip's five B3 rows, ragged
# Sq and Skv, non-causal, and query slices at offsets on and off the
# 128-key grid
ORDER_SHAPES = [
    (8, 12, 4, 1024, 1024, True, 0),
    (8, 12, 2, 1024, 1024, True, 0),
    (8, 24, 24, 1024, 1024, True, 0),
    (8, 32, 8, 1024, 1024, True, 0),
    (2, 12, 4, 1000, 1000, True, 0),
    (3, 6, 2, 200, 700, False, 0),
    (2, 36, 36, 2048, 32768, True, 30720),
    (1, 8, 2, 300, 4096, True, 300),
]


def _parent_order(b, h, hkv, sq, skv, causal, q_offset):
    """The order before bands: by query tile, heaviest first, then (head,
    batch) with the head fastest."""
    n_qt, hb = -(-sq // 128), h * b
    out = []
    for w in range(n_qt * hb):
        qt = n_qt - 1 - w // hb
        kend = min(skv, qt * 128 + 128 + q_offset) if causal else skv
        out.append((qt, (w % hb) % h, (w % hb) // h, -(-kend // 128)))
    return out


def _fast_div(d):
    """`fast_div` of csrc/flash_attention.cu: (d, mul, shr)."""
    if d == 1:
        return d, 0, 0
    lg = 0
    while (1 << lg) < d:
        lg += 1
    return d, ((1 << (31 + lg)) + d - 1) // d, lg - 1


def _quotient(n, f):
    """`quotient` of csrc/flash_attention.cu (`__umulhi`: the high 32
    bits of the 64-bit product)."""
    d, mul, shr = f
    return n if d == 1 else ((n * mul) >> 32) >> shr


def _kernel_work_item(w, b, h, hkv, sq, skv, causal, q_offset, band):
    """`work_item` of csrc/flash_attention.cu with the arguments
    `launch_tc` sets up, line for line."""
    group, n_qt = h // hkv, -(-sq // 128)
    pairs = b * hkv
    band = min(band, pairs)
    n_bands = (pairs + band - 1) // band
    band_items = _fast_div(band * n_qt * group)
    band_hb = _fast_div(band * group)
    last_hb = _fast_div((pairs - (n_bands - 1) * band) * group)
    k = _quotient(w, band_items)
    hb = last_hb if k == n_bands - 1 else band_hb
    r = w - k * band_items[0]
    if (n_bands - 1 - k) & 1:
        r = n_qt * hb[0] - 1 - r
    qt = _quotient(r, hb)
    f = k * band * group + (r - qt * hb[0])
    q0 = (n_qt - 1 - qt) * 128
    bb = _quotient(f, _fast_div(h))
    kend = min(skv, q0 + 128 + q_offset) if causal else skv
    return (q0 // 128, f - bb * h, bb, (kend + 127) // 128)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 12, 24, 36, 96, 100, 127,
                               128, 129, 768, 1000, 2304, 99991,
                               (1 << 20) + 1, (1 << 30) + 3, (1 << 31) - 1])
def test_fast_division_is_exact(d):
    """The kernel's quotient by a multiply and a shift equals n // d for
    every int n in [0, 2^31) near 0, near multiples of d and at the top
    (the work order's dividends are item indices, below 2^31)."""
    f = _fast_div(d)
    assert 0 <= f[1] < 1 << 32
    rng = np.random.default_rng(d)
    ns = {*range(4096), (1 << 31) - 1, *((1 << 31) - 1 - np.arange(4096))}
    for m in rng.integers(0, (1 << 31) // d, 4096):
        ns.update(int(m) * d + e for e in (-1, 0, 1, d - 1))
    for n in ns:
        if 0 <= n < 1 << 31:
            assert _quotient(int(n), f) == n // d, n


def _bands(shape, l2):
    b, h, hkv, sq, skv, causal, off = shape
    return [fa_kernel.kv_band(b, hkv, skv, 64, l2), 1, 2, 3, b * hkv]


@pytest.mark.parametrize("shape", ORDER_SHAPES)
def test_work_order_is_a_permutation_of_the_items(shape):
    """Every band size gives each (query tile, head, batch) once, with
    its causal key-tile count."""
    b, h, hkv, sq, skv, causal, off = shape
    want = sorted(_parent_order(*shape))
    for band in _bands(shape, H100_L2):
        got = fa_kernel.work_items(b, h, hkv, sq, skv, causal, off, band)
        assert sorted(got) == want, band


@pytest.mark.parametrize("shape", ORDER_SHAPES)
def test_work_order_is_what_the_kernel_computes(shape):
    """The plain order equals the kernel's `work_item` for w = 0, 1, ...,
    including a last band that is smaller (3 pairs a band), an odd and
    an even number of bands (1 and 2 pairs a band), and one band."""
    b, h, hkv, sq, skv, causal, off = shape
    n = -(-sq // 128) * h * b
    for band in _bands(shape, H100_L2 // 8):
        got = [_kernel_work_item(w, b, h, hkv, sq, skv, causal, off, band)
               for w in range(n)]
        assert got == fa_kernel.work_items(b, h, hkv, sq, skv, causal, off,
                                           band), band


@pytest.mark.parametrize("shape", ORDER_SHAPES)
@pytest.mark.parametrize("parts,whole", [(16, 16), (8, 8), (4, 4), (2, 2),
                                         (8, 4)])
def test_bands_hold_whole_groups_within_their_share_of_l2(
        shape, parts, whole, monkeypatch):
    """A whole K/V within l2 / whole is one band.  Otherwise a band is a
    run of whole (batch, kv head) pairs, so no GQA group is split, in as
    few bands as keep each within l2 / parts (a pair alone larger than
    that is a band of its own).  Inside a band the query tiles' weights
    run one way: heaviest first in the last band, and the bands before
    it alternate, so two neighbours meet at their light ends or their
    heavy ones.  (8, 4) is the wrapper's rule."""
    b, h, hkv, sq, skv, causal, off = shape
    group = h // hkv
    if (parts, whole) == (8, 4):
        assert (fa_kernel.L2_PARTS, fa_kernel.L2_WHOLE) == (8, 4)
    monkeypatch.setattr(fa_kernel, "L2_PARTS", parts)
    monkeypatch.setattr(fa_kernel, "L2_WHOLE", whole)
    for l2 in (H100_L2, 40 * MIB, 6 * MIB):
        for dh in (64, 128, 160):
            band = fa_kernel.kv_band(b, hkv, skv, dh, l2)
            pair = 2 * skv * dh * 2
            if b * hkv * pair <= l2 // whole:
                assert band == b * hkv
            else:
                assert band * pair <= l2 // parts or band == 1
                n_bands = -(-b * hkv // band)
                assert (n_bands == 1 or
                        -(-b * hkv // (n_bands - 1)) * pair > l2 // parts)
            items = fa_kernel.work_items(b, h, hkv, sq, skv, causal, off,
                                         band)
            per_band = band * group * -(-sq // 128)
            n_bands = -(-b * hkv // band)
            for i in range(0, len(items), per_band):
                mine = items[i:i + per_band]
                pairs = {bb * hkv + hh // group for _, hh, bb, _ in mine}
                assert pairs == set(range(i // per_band * band,
                                          i // per_band * band + len(pairs)))
                assert {(hh, bb) for _, hh, bb, _ in mine} == {
                    (u % hkv * group + gi, u // hkv) for u in pairs
                    for gi in range(group)}
                tiles = [nt for *_, nt in mine]
                heavy_first = (n_bands - 1 - i // per_band) % 2 == 0
                assert tiles == sorted(tiles, reverse=heavy_first)
                if i + per_band >= len(items):
                    assert heavy_first, "the last band runs heaviest first"


@pytest.mark.parametrize("shape", [ORDER_SHAPES[0], ORDER_SHAPES[1],
                                   ORDER_SHAPES[4], ORDER_SHAPES[5]])
def test_a_kv_that_fits_one_band_keeps_the_parent_order(shape):
    """The demo LM's K/V (8.4 MB) fits a quarter of the H100's L2: one
    band, the order by query tile that the kernel had before bands (and
    that its one-band instance decodes directly, `one_band_item`)."""
    b, h, hkv, sq, skv, causal, off = shape
    band = fa_kernel.kv_band(b, hkv, skv, 64, H100_L2)
    assert band == b * hkv
    assert fa_kernel.work_items(b, h, hkv, sq, skv, causal, off, band) == \
        _parent_order(*shape)


def test_band_rule_at_the_chips_shapes(monkeypatch):
    """At the H100's 50 MiB L2: MHA dh 64 (50.3 MB of K/V) in 8 bands of
    24 pairs (an eighth of L2 each), stablelm's dh 160 (41.9 MB) in 7 of
    10 (the last of 4), granite's H 16/8 (16.8 MB) in 3 of 22, the 32k
    offset row one pair a band (8.4 MB each); the demo LM and qwen2-vl
    (8.4 MB each, within a quarter of L2) one band, two at an eighth
    alone; and the K/V bytes each order reads (loaded by every item, and
    the misses `kv_traffic`'s model of L2 counts)."""
    rule = fa_kernel.kv_band
    assert rule(8, 24, 1024, 64, H100_L2) == 24
    assert rule(8, 8, 1024, 160, H100_L2) == 10
    assert rule(8, 8, 1024, 64, H100_L2) == 22
    assert rule(2, 36, 32768, 64, H100_L2) == 1
    assert rule(8, 4, 1024, 64, H100_L2) == 32
    assert rule(8, 2, 1024, 128, H100_L2) == 16
    with monkeypatch.context() as m:
        m.setattr(fa_kernel, "L2_WHOLE", 8)
        assert rule(8, 4, 1024, 64, H100_L2) == 16
    mb = {name: tuple(round(x / 1e6, 1) for x in fa_kernel.kv_traffic(
        *args, l2_bytes=H100_L2)) for name, args in {
        "mha one band": (8, 24, 24, 1024, 1024, 64, True, 0, 192),
        "mha": (8, 24, 24, 1024, 1024, 64, True, 0, 24),
        "dh160 one band": (8, 32, 8, 1024, 1024, 160, True, 0, 64),
        "dh160": (8, 32, 8, 1024, 1024, 160, True, 0, 10),
        "offset one band": (2, 36, 36, 2048, 32768, 64, True, 30720, 72),
        "offset": (2, 36, 36, 2048, 32768, 64, True, 30720, 1),
        "demo": (8, 12, 4, 1024, 1024, 64, True, 0, 32)}.items()}
    assert mb == {"mha one band": (226.5, 226.5), "mha": (226.5, 50.3),
                  "dh160 one band": (755.0, 188.7), "dh160": (755.0, 41.9),
                  "offset one band": (9380.6, 9380.6),
                  "offset": (9380.6, 604.0), "demo": (113.2, 8.4)}


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
