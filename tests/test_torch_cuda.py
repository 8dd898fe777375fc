"""Card-only tests of the PyTorch port: the CUDA decode-attention (B1,
B2), flash-attention (B3) and RG-LRU scan (B4, forward and backward)
kernels against their plain versions at the full widths of the demo LM
and recurrentgemma-2b
(B1/B2 also at the decode widths of minicpm-2b, stablelm-12b, command-r-35b
and qwen2.5-32b; B3 at stablelm-12b's dh 160; all three at the reduced
configs' head dims, zero-padded to 64), the engines on the card (the MoE
and xLSTM families and the new transformer branches too), the MoE,
xLSTM and RG-LRU families' train steps under deterministic algorithms,
and the SDC injector's flips on the card against the CPU.  Each
skips, with its reason, where there is no CUDA device; the file imports
no JAX, so it also runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_reference, paged_decode_attention)
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels._build import Library  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_backward_reference, rglru_scan_reference)
from repro_torch.kernels.rglru_scan import kernel as rglru_scan_kernel  # noqa: E402,E501
from repro_torch.kernels.rglru_scan.kernel import (  # noqa: E402
    rglru_scan_bwd, rglru_scan_fwd)
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501
from repro_torch.sync import no_host_sync  # noqa: E402

# the plain version computes in f32 and rounds once; the kernel's online
# softmax sums in another order: f32 2e-5, bf16 one output ulp (2e-2)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# positions per split of the decode-attention kernels (the source's C)
# B3's and B4's libraries as their sources build them (the perturbation
# tests swap them)
_FA_LIBRARY = fa_kernel.LIBRARY
_SCAN_LIBRARY = rglru_scan_kernel.LIBRARY
CHUNK = int(re.search(r"^constexpr int C = (\d+);",
                      da_kernel.LIBRARY.source.read_text(), re.M)[1])


def _bf16_share(out, ref):
    """The worst share of the bf16 limit: 2e-2 of each (row, head)'s
    largest |ref|, at most 2e-2, and never below 2 bf16 ulps of the
    element's |ref|; the kernel (P rounded to bf16 for P.V) and the plain
    version round differently.  Where a row stays at or below 1 the scaled
    part is at least 2.5 ulps and the floor never binds; B3's short causal
    rows are near single v values of 2 to 8, where 2e-2 alone is 1.28 to
    0.64 ulps.  A flat 2e-2 would pass a decode kernel that drops a
    position per split of a 2048-position row, whose outputs are ~0.03."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ulp = (2.0 ** (r.frexp().exponent - 8).float()).where(r > 0, 0.0)
    lim = (TOL["bfloat16"] * r.amax(-1, keepdim=True).clamp(
        max=1.0)).maximum(2 * ulp)
    return (d / lim).where(d > 0, 0.0).amax().item()   # 0 / 0 is no error


def _assert_close_to_plain(out, ref, dtype):
    """An attention kernel (B1, B2, B3) against its plain version.  f32:
    2e-5 (atol and rtol).  bf16: within `_bf16_share`'s limit."""
    if dtype == "float32":
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-5,
                                   rtol=2e-5)
        return
    share = _bf16_share(out, ref)
    assert share <= 1, f"bf16 error is {share:.3f} of its limit"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [8, 64])
def test_kernels_match_plain_at_full_width(cuda_device, dtype, b):
    """suncatcher-lm-100m widths: H 12, Hkv 4, dh 64, M 1024, ragged
    kv_len; B2 == B1 bitwise with a NaN trash page."""
    h, hkv, m, dh, ps = 12, 4, 1024, 64, 16
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(b)
    q = torch.randn(b, h, dh, generator=g).to(cuda_device, dt)
    kc = torch.randn(b, m, hkv, dh, generator=g).to(cuda_device, dt)
    vc = torch.randn(b, m, hkv, dh, generator=g).to(cuda_device, dt)
    lens = torch.randint(0, m + 1, (b,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = 0, 33
    lens = lens.to(cuda_device)
    out = decode_attention(q, kc, vc, lens)
    ref = decode_attention_reference(q, kc, vc, lens)
    _assert_close_to_plain(out, ref, dtype)
    assert bool((out[0] == 0).all())
    mp = m // ps
    kp = torch.cat([kc.reshape(b * mp, ps, hkv, dh),
                    torch.full((1, ps, hkv, dh), float("nan"), dtype=dt,
                               device=cuda_device)])
    vp = torch.cat([vc.reshape(b * mp, ps, hkv, dh), kp[-1:]])
    ptab = torch.arange(b * mp, dtype=torch.int32,
                        device=cuda_device).reshape(b, mp)
    live = (lens[:, None] + ps - 1) // ps
    ptab = torch.where(torch.arange(mp, device=cuda_device) < live, ptab,
                       b * mp).to(torch.int32)
    assert torch.equal(paged_decode_attention(q, kp, vp, ptab, lens), out)


@pytest.mark.cuda
def test_engine_on_card_paged_equals_dense_through_the_kernels(cuda_device):
    # reduced widths with head_dim 64: the kernels take 64 and 128
    cfg = registry.get_reduced_config("suncatcher-lm-100m", head_dim=64)
    fns = registry.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 40, 6)]
    streams = []
    for page_size in (0, 16):
        eng = ServingEngine(cfg, fns, params,
                            EngineConfig(max_batch=3, max_len=64, seed=7,
                                         page_size=page_size))
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=9,
                               temperature=3.0 if uid % 2 else 0.0))
        before = (decode_attention.launches, paged_decode_attention.launches)
        done = eng.run()
        launched = (decode_attention.launches - before[0],
                    paged_decode_attention.launches - before[1])
        sub = cfg.n_layers * eng.stats["decode_blocks"] * 8
        assert launched == ((sub, 0) if not page_size else (0, sub))
        streams.append({r.uid: r.generated for r in done})
    assert streams[0] == streams[1]
    assert all(len(v) == 9 for v in streams[0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (8, 12, 4, 1024, 64),       # the training shape
    (2, 12, 4, 1000, 64),       # ragged: not a multiple of 64
    (2, 12, 12, 256, 64),       # MHA
    (2, 12, 1, 256, 64),        # MQA
    (2, 8, 2, 200, 128),        # head_dim 128, ragged
    (2, 8, 2, 300, 160),        # head_dim 160 (stablelm-12b), ragged
    (2, 4, 2, 100, 16),         # head_dim 16, zero-padded to 64, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda_device, b, h, hkv, s, dh, dtype,
                                    causal):
    """B3 in the model layout (B, S, H, dh) against the plain version:
    f32 2e-5; bf16 the scaled limit of `_bf16_share` (the kernel rounds P
    to bf16 for the P V product and the output once).  Two calls are
    bitwise equal.  At the training shape the plain version leaving out
    one key in 128 (a kernel that lost a key per tile) fails the limit."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(s + dh)
    q = torch.randn(b, s, h, dh, generator=g).to(cuda_device, dt)
    k = torch.randn(b, s, hkv, dh, generator=g).to(cuda_device, dt)
    v = torch.randn(b, s, hkv, dh, generator=g).to(cuda_device, dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    ref = attention_reference(qh, kh, vh, causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    _assert_close_to_plain(out, ref, dtype)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    if (b, s, dtype, causal) == (8, 1024, "bfloat16", True):
        kh, vh = (t.float().repeat_interleave(h // hkv, dim=1)
                  for t in (kh, vh))
        sc = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh) * dh ** -0.5
        pos = torch.arange(s, device=cuda_device)
        keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] % 128 != 127)
        planted = torch.einsum("bhqk,bhkd->bhqd", sc.masked_fill(
            ~keep, float("-inf")).softmax(-1), vh).to(dt).transpose(1, 2)
        share = _bf16_share(planted, ref)
        print(f"planted fault: {share:.3f} of the bf16 limit")
        assert share > 1, "the bf16 limit passes a planted fault"


@pytest.mark.cuda
def test_flash_gradients_match_autograd_through_plain(cuda_device):
    """The backward differentiates the plain formula, as the reference's
    custom_vjp does: gradients equal autograd through the plain version
    (the forward outputs differ, the backward recomputes from q, k, v)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(2, 256, n, 64, generator=g).to(cuda_device)
               for n in (12, 4, 4))
    go = torch.randn(2, 256, 12, 64, generator=g).to(cuda_device)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), go)
    want = torch.autograd.grad(attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ).transpose(1, 2), (q, k, v), go)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda_device):
    q = torch.randn(1, 64, 2, 96, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q, q)
    # TMA needs a 16-byte aligned base: a view two bytes in
    flat = torch.randn(64 * 2 * 64 + 8, device=cuda_device,
                       dtype=torch.bfloat16)
    q = flat[1:1 + 64 * 2 * 64].view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_flash_kernel_at_stablelm_training_shape(cuda_device):
    """B3's dh 160 instance (five 32-column boxes under the 64-byte
    swizzle, a two-stage ring, P.V at n160) at stablelm-12b's training
    shape (B 8, H 32/8, S 1024, bf16, causal): within the bf16 limit of
    the plain version, two calls bitwise equal, and the plain version
    leaving out one key in 128 fails the limit."""
    b, h, hkv, s, dh = 8, 32, 8, 1024, 160
    g = torch.Generator(device="cpu").manual_seed(160)
    q, k, v = (torch.randn(b, s, n, dh, generator=g).to(
        cuda_device, torch.bfloat16) for n in (h, hkv, hkv))
    out = flash_attention(q, k, v, causal=True)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    ref = attention_reference(qh, kh, vh, causal=True).transpose(1, 2)
    share = _bf16_share(out, ref)
    assert share <= 1, f"bf16 error is {share:.3f} of its limit"
    assert torch.equal(out, flash_attention(q, k, v, causal=True))
    kh, vh = (t.float().repeat_interleave(h // hkv, dim=1) for t in (kh, vh))
    sc = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh) * dh ** -0.5
    pos = torch.arange(s, device=cuda_device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] % 128 != 127)
    planted = torch.einsum("bhqk,bhkd->bhqd", sc.masked_fill(
        ~keep, float("-inf")).softmax(-1), vh).bfloat16().transpose(1, 2)
    assert _bf16_share(planted, ref) > 1, "the limit passes a planted fault"


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,skv,q_offset,bands", [
    (8, 24, 24, 1024, 1024, 0, (1, 48, 192)),      # MHA: the rule's 8 x 24
    (1, 8, 8, 512, 16384, 15872, (1, 3, 8)),       # long keys: 1 pair a band
    (2, 12, 4, 1000, 1000, 0, (1, 3, 8)),          # ragged; 3 leaves 2
])
def test_flash_kernel_work_order_changes_no_bit(cuda_device, b, h, hkv, sq,
                                                skv, q_offset, bands):
    """B3's bf16 kernel in bands of (batch, kv head) pairs (`kv_band`'s
    rule at the card's L2, and the bands given: one pair, a size that
    does not divide the pairs, all pairs): within the bf16 limit of the
    plain version, two calls bitwise equal, one launch counted per call,
    and every band size bitwise equal to the rule's."""
    g = torch.Generator(device="cpu").manual_seed(sq + skv)
    q, k, v = (torch.randn(b, n, hh, 64, generator=g).to(
        cuda_device, torch.bfloat16) for n, hh in ((sq, h), (skv, hkv),
                                                   (skv, hkv)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert flash_attention.launches == before + 1
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    ref = attention_reference(qh, kh, vh, causal=True,
                              q_offset=q_offset).transpose(1, 2)
    share = _bf16_share(out, ref)
    assert share <= 1, f"bf16 error is {share:.3f} of its limit"
    assert torch.equal(out, flash_attention(q, k, v, causal=True,
                                            q_offset=q_offset))
    for band in bands:
        got = fa_kernel.flash_attention_fwd(qh, kh, vh, causal=True,
                                            q_offset=q_offset, band=band)
        assert torch.equal(got.transpose(1, 2), out), band


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [8, 12, 16, 20])
def test_kernels_at_the_reduced_head_dims(cuda_device, dtype, dh):
    """The reduced configs' head dims run on the 64 instances, zero-padded
    by the wrappers at the true dh's scale: B1 and B3 within their limits
    of the plain versions, each call counted as a launch, B2 == B1
    bitwise over shuffled pages with a NaN trash page, outputs of the
    true width."""
    b, h, hkv, m, ps = 4, 4, 2, 128, 16
    q, kc, vc = _decode_inputs(cuda_device, dtype, b, h, hkv, m, dh, dh)
    lens = torch.tensor([0, 1, 77, 128], dtype=torch.int32,
                        device=cuda_device)
    before = (decode_attention.launches, paged_decode_attention.launches,
              flash_attention.launches)
    out = decode_attention(q, kc, vc, lens)
    assert out.shape == (b, h, dh) and out.is_contiguous()
    _assert_close_to_plain(out, decode_attention_reference(q, kc, vc, lens),
                           dtype)
    mp = m // ps
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
        dh)).to(cuda_device)
    kp = torch.full((b * mp + 1, ps, hkv, dh), float("nan"), dtype=kc.dtype,
                    device=cuda_device)
    vp = kp.clone()
    live = torch.arange(mp, device=cuda_device) < ((lens + ps - 1) // ps
                                                   )[:, None]
    ptab = torch.where(live, perm.reshape(b, mp), b * mp).to(torch.int32)
    kp[ptab[live].long()] = kc.reshape(b, mp, ps, hkv, dh)[live]
    vp[ptab[live].long()] = vc.reshape(b, mp, ps, hkv, dh)[live]
    assert torch.equal(paged_decode_attention(q, kp, vp, ptab, lens), out)
    g = torch.Generator(device="cpu").manual_seed(dh)
    qs, ks, vs = (torch.randn(2, 200, n, dh, generator=g).to(
        cuda_device, getattr(torch, dtype)) for n in (h, hkv, hkv))
    fo = flash_attention(qs, ks, vs, causal=True)
    assert fo.shape == qs.shape
    ref = attention_reference(*(t.transpose(1, 2) for t in (qs, ks, vs)),
                              causal=True).transpose(1, 2)
    _assert_close_to_plain(fo, ref, dtype)
    assert (decode_attention.launches, paged_decode_attention.launches,
            flash_attention.launches) == tuple(n + 1 for n in before)


def _jittered_flash_source(race):
    """flash_attention.cu with a warpgroup-uniform pseudo-random sleep of
    0-4 us before every consumer step and producer load; `race` plants a
    slot handed back to the producer, and a sleep, before the wgmma that
    reads it is issued: the K slot of an item's first tile ("k"; there
    the previous item's last V slot is already back, so the producer,
    STAGES tiles ahead on an item of more tiles, can be waiting on just
    that K slot), a V slot ("v") or the Q tile ("q")."""
    def sub(text, a, b):
        assert text.count(a) == 1, a
        return text.replace(a, b)
    s = fa_kernel.LIBRARY.source.read_text()
    s = sub(s, "__device__ __forceinline__ uint32_t smem_u32(", """
__device__ __forceinline__ void jitter(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  __nanosleep((x ^ (x >> 16)) & 4095u);
}
__device__ __forceinline__ uint32_t smem_u32(""")
    for a, seed in (("  float alpha[2];\n  mbar_wait(", "c.q_tile * 31u + g"),
                    ("  const int s = g % L::STAGES;\n  mbar_wait(c.v_full",
                     "c.q_tile * 31u + g + 5u"),
                    ("      mbar_wait(q_full, j & 1);",
                     "threadIdx.x / 128 * 31u + j * 101u"),
                    ("        mbar_wait(q_empty, (j & 1) ^ 1);",
                     "104729u + j * 17u"),
                    ("          mbar_wait(k_empty + 8 * s,", "104729u + g"),
                    ("          mbar_wait(v_empty + 8 * s,",
                     "104729u + g + 7u")):
        pad = a[:len(a) - len(a.lstrip(" \n"))].split("\n")[-1]
        at = a.rindex("mbar_wait(")
        s = sub(s, a, f"{a[:at]}jitter(blockIdx.x * 7919u + {seed});\n"
                f"{pad}{a[at:]}")
    issue = "  issue_values<L>(o, p, c.base + L::V + sp * L::KV_BYTES);\n"
    if race == "k":
        s = sub(s, "      fence_regs(sc);\n"
                "      mbar_arrive(k_empty + 8 * s);\n",
                "      fence_regs(sc);\n")
        first = ("      issue_scores<L>(sc, c.q_tile, base + L::K + s * "
                 "L::KV_BYTES);\n")
        s = sub(s, first, "      mbar_arrive(k_empty + 8 * s);\n"
                "      jitter(blockIdx.x * 7u + c.g0 + 1u);\n" + first)
    if race == "v":
        s = sub(s, "  fence_regs(o);\n  mbar_arrive(c.v_empty + 8 * sp);\n",
                "  fence_regs(o);\n")
        s = sub(s, issue, "  mbar_arrive(c.v_empty + 8 * sp);\n"
                "  jitter(blockIdx.x * 7u + g);\n" + issue)
    if race == "q":
        s = sub(s, "  if (it == c.n_tiles - 1) mbar_arrive(c.q_empty);\n", "")
        s = sub(s, "  issue_scores<L>(sc, c.q_tile, c.base + L::K + s * "
                "L::KV_BYTES);\n  issue_values",
                "  if (it == c.n_tiles - 1) {\n    mbar_arrive(c.q_empty);\n"
                "    jitter(blockIdx.x * 7u + g + 3u);\n  }\n"
                "  issue_scores<L>(sc, c.q_tile, c.base + L::K + s * "
                "L::KV_BYTES);\n  issue_values")
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("race", [None, "k", "v", "q"])
def test_flash_kernel_is_bitwise_stable_under_timing_perturbation(
        cuda_device, tmp_path, monkeypatch, race):
    """The bf16 kernel's ring synchronisation, checked by perturbing its
    timing, which needs no tool support (compute-sanitizer can refuse a
    device as unsupported): with random sleeps in the producer and both
    consumers, the outputs stay bitwise equal to the unperturbed
    kernel's, over several items per CTA (768 items at the training
    shape, 384 at S 700 dh 128, 192 at S 700 dh 160 on its two-stage
    ring), in one band and in bands of one (batch, kv head) pair (the
    order that alternates its bands), while a planted early release of
    an item's first K slot, of a V slot or of the Q tile changes them
    (items of up to 8, 6 and 6 key tiles, more than the ring's stages)."""
    src = tmp_path / "csrc" / "flash_attention.cu"
    src.parent.mkdir()
    src.write_text(_jittered_flash_source(race))
    jittered = Library(src, fa_kernel._declare)
    changed = 0
    for b, h, hkv, s, dh, causal in ((8, 12, 4, 1024, 64, True),
                                     (8, 8, 2, 700, 128, False),
                                     (8, 4, 2, 700, 160, True)):
        g = torch.Generator(device="cpu").manual_seed(s + dh)
        q, k, v = (torch.randn(b, h if n == "q" else hkv, s, dh, generator=g
                               ).to(cuda_device, torch.bfloat16)
                   for n in "qkv")
        for band in (b * hkv, 1):
            monkeypatch.setattr(fa_kernel, "LIBRARY", _FA_LIBRARY)
            want = fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                                 band=band)
            monkeypatch.setattr(fa_kernel, "LIBRARY", jittered)
            for _ in range(3):
                got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                                    band=band)
                changed += int((got != want).sum())
    print(f"planted race {race}: {changed} outputs moved in 18 calls")
    if race is None:
        assert changed == 0, f"{changed} outputs moved under perturbation"
    else:
        assert changed > 0, f"the planted {race} race went unseen"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_head_dim_256_mqa(cuda_device, dtype):
    """recurrentgemma-2b's ring decode: H 10 on Hkv 1 (group 10), dh 256,
    a 2048-slot ring (32 splits), ragged kv_len including 0 and the full
    ring (a split CTA's ~79 KB of shared memory in bf16, ~146 KB in f32,
    needs the opt-in above 48 KB)."""
    b, h, hkv, m, dh = 6, 10, 1, 2048, 256
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(256)
    q = torch.randn(b, h, dh, generator=g).to(cuda_device, dt)
    kc = torch.randn(b, m, hkv, dh, generator=g).to(cuda_device, dt)
    vc = torch.randn(b, m, hkv, dh, generator=g).to(cuda_device, dt)
    lens = torch.tensor([0, 2048, 1, 33, 1000, 2047], dtype=torch.int32,
                        device=cuda_device)
    out = decode_attention(q, kc, vc, lens)
    ref = decode_attention_reference(q, kc, vc, lens)
    _assert_close_to_plain(out, ref, dtype)
    assert bool((out[0] == 0).all())


def _planted_decode(q, kc, vc, lens, every):
    """The plain decode attention leaving out positions t % every ==
    every - 1: what a kernel that lost one position per split gives."""
    b, h, dh = q.shape
    m, hkv = kc.shape[1], kc.shape[2]
    s = torch.einsum("bhgd,bmhd->bhgm", q.float().reshape(b, hkv, -1, dh),
                     kc.float()) * dh ** -0.5
    t = torch.arange(m, device=q.device)
    keep = (t < lens[:, None]) & (t % every != every - 1)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    return torch.einsum("bhgm,bmhd->bhgd", s.softmax(-1), vc.float()
                        ).reshape(b, h, dh).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 160), (64, 8, 128),
                                      (40, 8, 128), (36, 36, 64)])
def test_decode_kernels_at_the_new_serving_widths(cuda_device, dtype, h,
                                                  hkv, dh):
    """B1 and B2 at stablelm-12b's decode widths (dh 160: five P.V
    n-tiles per warp, the fifth from an x2 ldmatrix), command-r-35b's and
    qwen2.5-32b's (dh 128, groups of 8 and 5) and minicpm-2b's (MHA, a
    group of 1 padded to 16 rows), ragged kv_len (0, non-multiples of 64,
    full rows) against the plain version; a second call and the paged
    kernel over shuffled pages with a NaN trash page give the same
    bits."""
    b, m, ps = 8, 512, 16
    q, kc, vc = _decode_inputs(cuda_device, dtype, b, h, hkv, m, dh, dh + h)
    lens = torch.tensor([0, 1, 63, 65, 200, 232, m - 1, m],
                        dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, kc, vc, lens)
    ref = decode_attention_reference(q, kc, vc, lens)
    _assert_close_to_plain(out, ref, dtype)
    assert bool((out[0] == 0).all())
    assert torch.equal(decode_attention(q, kc, vc, lens), out)
    mp = m // ps
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
        dh)).to(cuda_device)
    kp = torch.full((b * mp + 1, ps, hkv, dh), float("nan"), dtype=kc.dtype,
                    device=cuda_device)
    vp = kp.clone()
    live = torch.arange(mp, device=cuda_device) < ((lens + ps - 1) // ps
                                                   )[:, None]
    ptab = torch.where(live, perm.reshape(b, mp), b * mp).to(torch.int32)
    kp[ptab[live].long()] = kc.reshape(b, mp, ps, hkv, dh)[live]
    vp[ptab[live].long()] = vc.reshape(b, mp, ps, hkv, dh)[live]
    assert torch.equal(paged_decode_attention(q, kp, vp, ptab, lens), out)


@pytest.mark.cuda
def test_bf16_limit_catches_a_planted_fault_at_head_dim_160(cuda_device):
    """At stablelm-12b's widths the bf16 limit passes B1 and fails the
    plain version that leaves out one position in 64 (one per split)."""
    b, h, hkv, m, dh = 4, 32, 8, 512, 160
    q, kc, vc = _decode_inputs(cuda_device, "bfloat16", b, h, hkv, m, dh, 5)
    lens = torch.tensor([512, 511, 300, 200], dtype=torch.int32,
                        device=cuda_device)
    ref = decode_attention_reference(q, kc, vc, lens)
    assert _bf16_share(decode_attention(q, kc, vc, lens), ref) <= 1
    planted = _planted_decode(q, kc, vc, lens, CHUNK)
    assert _bf16_share(planted, ref) > 1


def _decode_inputs(device, dtype, b, h, hkv, m, dh, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*shape, generator=g).to(device, getattr(torch, dtype))
            for shape in ((b, h, dh), (b, m, hkv, dh), (b, m, hkv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv,dh", [(12, 4, 64), (10, 1, 256)])
def test_split_kernel_at_chunk_edges(cuda_device, dtype, h, hkv, dh):
    """kv_len on the split edges (0, 1, C-1, C, C+1, 2C-1, 2C, 2C+1, the
    full cache) against the plain version, at the demo LM's and
    recurrentgemma-2b's head widths; a second call gives the same bits (no
    atomics, a fixed merge order)."""
    c = CHUNK
    m = 4 * c + 24
    lens = [0, 1, c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1, m]
    q, kc, vc = _decode_inputs(cuda_device, dtype, len(lens), h, hkv, m, dh,
                               dh)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = da_kernel.decode_attention_fwd(q, kc, vc, lens)
    again = da_kernel.decode_attention_fwd(q, kc, vc, lens)
    ref = decode_attention_reference(q, kc, vc, lens)
    _assert_close_to_plain(out, ref, dtype)
    assert torch.equal(out, again)
    assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_equals_dense_bitwise_across_many_splits(cuda_device, dtype,
                                                       ps):
    """recurrentgemma-2b's ring widths (H 10, Hkv 1, dh 256) on a
    2048-position cache (32 splits), pages shuffled over the pool: B2 ==
    B1 bitwise, with NaN in the trash page and in every page no live
    position maps to."""
    b, h, hkv, m, dh = 6, 10, 1, 2048, 256
    q, kc, vc = _decode_inputs(cuda_device, dtype, b, h, hkv, m, dh, 7)
    lens = torch.tensor([2048, 0, 1, 64, 1000, 2047], dtype=torch.int32,
                        device=cuda_device)
    mp = m // ps
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
        ps)).to(cuda_device)
    kp = torch.full((b * mp + 1, ps, hkv, dh), float("nan"),
                    dtype=kc.dtype, device=cuda_device)
    vp = kp.clone()
    ptab = perm.reshape(b, mp).to(torch.int32)
    live = torch.arange(mp, device=cuda_device) < ((lens + ps - 1) // ps
                                                   )[:, None]
    ptab = torch.where(live, ptab, b * mp).to(torch.int32)
    kp[ptab[live].long()] = kc.reshape(b, mp, ps, hkv, dh)[live]
    vp[ptab[live].long()] = vc.reshape(b, mp, ps, hkv, dh)[live]
    dense = decode_attention(q, kc, vc, lens)
    paged = paged_decode_attention(q, kp, vp, ptab, lens)
    assert torch.equal(paged, dense)
    assert bool(torch.isfinite(paged).all())


@pytest.mark.cuda
def test_decode_kernels_and_block_take_no_host_sync(cuda_device):
    """The wrappers read nothing back from the card (the split count comes
    from shapes): both kernels launch under sync debug mode "error", and
    so does the engine's decode block on the card."""
    q, kc, vc = _decode_inputs(cuda_device, "bfloat16", 4, 12, 4, 256, 64, 3)
    lens = torch.tensor([0, 5, 129, 256], dtype=torch.int32,
                        device=cuda_device)
    ptab = torch.arange(16, dtype=torch.int32,
                        device=cuda_device).reshape(4, 4)
    kp, vp = (torch.cat([t.reshape(16, 64, 4, 64), t[:1, :64]])
              for t in (kc, vc))
    with no_host_sync(cuda_device):
        dense = decode_attention(q, kc, vc, lens)
        paged = paged_decode_attention(q, kp, vp, ptab, lens)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)
    cfg = registry.get_reduced_config("suncatcher-lm-100m", head_dim=64)
    fns = registry.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, cuda_device)
    eng = ServingEngine(cfg, fns, params,
                        EngineConfig(max_batch=2, max_len=64, decode_block=8))
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=np.arange(3 + uid, dtype=np.int32),
                           max_new_tokens=12))
    done = eng.run()
    assert eng.stats["decode_blocks"] > 0 and len(done) == 2


def _scan_inputs(device, b, s, d, dtype, seed, off=0):
    """a in [0.2, 0.999), x normal; `off` > 0 puts both in views `off`
    elements into larger buffers (bases off 16-byte alignment)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.empty(b, s, d).uniform_(0.2, 0.999, generator=g).to(device, dt)
    x = torch.randn(b, s, d, generator=g).to(device, dt)
    if off:
        a, x = (torch.empty(t.numel() + off, dtype=dt, device=device)
                [off:].view_as(t).copy_(t) for t in (a, x))
    return a, x


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,dtype", [
    (16, 256, 2560, "float32"),     # the serve prefill shape
    (3, 100, 70, "float32"),        # ragged: no padding anywhere
    (2, 2048, 2560, "float32"),     # the long prefill's bucket
    (1, 512, 256, "bfloat16"),
    (1, 2048, 2560, "float32"),     # B = 1: 80 channel tiles
    (3, 1001, 2600, "float32"),     # S, D off the stage and tile sizes
    (2, 2048, 2560, "bfloat16"),
    (2, 300, 77, "bfloat16"),       # odd D: widened to f32 (cp.async)
    # recurrentgemma-2b prefill_32k on a rank of (16, 16): 2 rows, 32,768
    # steps, 2560 / 16 channels (two channel tiles)
    (2, 32768, 160, "float32"),
    # recurrentgemma-2b train_4k on a rank of (16, 16): a microbatch's 8
    # rows, 4,096 steps, 160 channels
    (8, 4096, 160, "float32"),
])
def test_rglru_scan_kernel_matches_plain(cuda_device, b, s, d, dtype):
    """B4 against the plain version: bitwise at f32 (the same two
    roundings per step); bf16 within tests/test_kernels.py::_tol x 5 (the
    f32 carry is the same, the output rounds once)."""
    dt = getattr(torch, dtype)
    a, x = _scan_inputs(cuda_device, b, s, d, dtype, b * s + d)
    before = rglru_scan_fwd.launches
    out = rglru_scan(a, x)
    assert rglru_scan_fwd.launches == before + 1
    ref = rglru_scan_reference(a, x)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == x.shape
    if dtype == "float32":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=0.1,
                                   rtol=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,off,path", [
    (2560, "float32", 0, "tma"),
    (2560, "float32", 1, "cp.async"),     # bases 4 bytes off
    (70, "float32", 0, "cp.async"),       # rows of 280 bytes
    (2600, "bfloat16", 0, "tma"),
    (2560, "bfloat16", 1, "cp.async"),    # bases 2 bytes off: widened
])
def test_rglru_scan_kernel_copy_paths(cuda_device, d, dtype, off, path):
    """Each copy path that fills the ring, at 1001 steps (not a multiple
    of the 32-step stage): f32 bitwise equal to the plain version, and a
    bf16 layout TMA cannot take (widened to f32) bitwise equal to the
    plain version too (the same carry, one rounding to nearest even)."""
    a, x = _scan_inputs(cuda_device, 2, 1001, d, dtype, d + off, off)
    assert rglru_scan_kernel.copy_path(a, x) == path
    out = rglru_scan(a, x)
    assert out.dtype == x.dtype
    assert torch.equal(out, rglru_scan_reference(a, x))


def _jittered_scan_source(race):
    """rglru_scan.cu with a warp-uniform pseudo-random sleep of 0-4 us
    before every copy issue (both paths) and every wait of the walker, in
    the forward and the backward kernel alike (their loops share these
    lines); `race` plants an early release: the walker hands each stage
    back to the producer before it reads it."""
    def sub(text, a, b, n=2):
        assert text.count(a) == n, a
        return text.replace(a, b)
    s = rglru_scan_kernel.LIBRARY.source.read_text()
    s = sub(s, "__device__ __forceinline__ uint32_t smem_u32(", """
__device__ __forceinline__ void jitter(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  __nanosleep((x ^ (x >> 16)) & 4095u);
}
__device__ __forceinline__ uint32_t smem_u32(""", n=1)
    s = sub(s, "          mbar_expect_tx(full + 8 * s,",
            "          jitter(blockIdx.x * 7919u + k * 31u + 1u);\n"
            "          mbar_expect_tx(full + 8 * s,")
    # the cp.async producers' wait for a free stage (the TMA producers'
    # are indented deeper)
    free = "\n        mbar_wait(empty + 8 * s, ((k / NS) & 1) ^ 1);\n"
    s = sub(s, free,
            free + "        jitter(blockIdx.x * 7919u + k * 31u + 2u);\n")
    wait = "    mbar_wait(full + 8 * s, (k / NS) & 1);\n"
    s = sub(s, wait, "    jitter(blockIdx.x * 7919u + k * 31u + 3u);\n" + wait)
    if race:
        s = sub(s, "mbar_arrive(empty + 8 * s);", "", n=4)
        s = sub(s, wait, wait + "    mbar_arrive(empty + 8 * s);\n"
                "    jitter(blockIdx.x * 7919u + k * 31u + 4u);\n")
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("race", [False, True])
def test_rglru_scan_kernel_is_bitwise_stable_under_timing_perturbation(
        cuda_device, tmp_path, monkeypatch, race):
    """The rings' synchronisation, checked by perturbing their timing
    (compute-sanitizer can refuse a device as unsupported): with random
    sleeps before the producer's copies and the walker's waits, three
    calls of the forward and of the backward at the long prefill shape
    (TMA), bf16 at ragged S and D (TMA; the backward widens it) and a
    ragged f32 layout (cp.async) stay bitwise equal to the unperturbed
    kernels', while a planted early release of each stage changes
    both."""
    src = tmp_path / "csrc" / "rglru_scan.cu"
    src.parent.mkdir()
    src.write_text(_jittered_scan_source(race))
    jittered = Library(src, rglru_scan_kernel._declare)
    changed = {"forward": 0, "backward": 0}
    for b, s, d, dtype in ((4, 2048, 2560, "float32"),
                           (3, 1001, 2600, "bfloat16"),
                           (3, 1001, 70, "float32")):
        a, x = _scan_inputs(cuda_device, b, s, d, dtype, s + d)
        h, g = rglru_scan_fwd(a.float(), x.float()), x.flip(1).contiguous()
        monkeypatch.setattr(rglru_scan_kernel, "LIBRARY", _SCAN_LIBRARY)
        want = rglru_scan_fwd(a, x), rglru_scan_bwd(a, h, g)
        monkeypatch.setattr(rglru_scan_kernel, "LIBRARY", jittered)
        for _ in range(3):
            got = rglru_scan_fwd(a, x), rglru_scan_bwd(a, h, g)
            changed["forward"] += int((got[0] != want[0]).sum())
            changed["backward"] += sum(int((u != w).sum())
                                       for u, w in zip(got[1], want[1]))
    print(f"planted early release {race}: outputs moved in 9 calls "
          f"{changed}")
    for kind, n in changed.items():
        if race:
            assert n > 0, f"the planted early release went unseen ({kind})"
        else:
            assert n == 0, f"{n} {kind} outputs moved under perturbation"


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,dtype,off", [
    (8, 1024, 2560, "float32", 0),    # recurrentgemma's training shape
    (3, 100, 70, "float32", 0),       # ragged: cp.async
    (2, 517, 2560, "float32", 1),     # bases 4 bytes off: cp.async
    (3, 1001, 2600, "float32", 0),    # S, D off the stage and tile sizes
    (2, 16, 128, "float32", 0),       # one whole stage
    (2, 1, 128, "float32", 0),        # S = 1: dh = g, da = g * 0.0
    (8, 1024, 4, "float32", 0),       # xLSTM's prefix sums (H 4)
    (8, 4096, 160, "float32", 0),     # recurrentgemma-2b train_4k's rank
    (1, 512, 256, "bfloat16", 0),
    (2, 300, 77, "bfloat16", 0),
])
def test_rglru_scan_bwd_kernel_matches_plain(cuda_device, b, s, d, dtype,
                                             off):
    """B4's backward against the plain reverse walk, bit patterns equal
    (da_0's -0.0 included) on both copy paths; a bf16 a and g widen
    exactly and the gradients round once, as the plain version rounds
    them, so bf16 is bitwise too.  One call is one launch."""
    a, x = _scan_inputs(cuda_device, b, s, d, dtype, b * s + d)
    g = torch.randn(b, s, d, generator=torch.Generator().manual_seed(s)
                    ).to(cuda_device, a.dtype)
    h = rglru_scan_fwd(a.float(), x.float())
    if off:
        a, h, g = (torch.empty(t.numel() + off, dtype=t.dtype,
                               device=cuda_device)[off:].view_as(t).copy_(t)
                   for t in (a, h, g))
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(a, h, g)
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_scan_backward_reference(a, h, g)
    torch.cuda.synchronize()
    for u, w in zip(got, want):
        assert u.dtype == w.dtype
        assert torch.equal(_bits(u), _bits(w))


@pytest.mark.cuda
def test_rglru_scan_backward_is_one_launch_per_call(cuda_device):
    """Through the autograd wrapper, each backward launches B4's backward
    kernel once (no Python loop over S), each forward the forward
    kernel once, and the gradients equal autograd through the plain
    formula bitwise; a bf16 x saves its f32 carry."""
    for dtype in ("float32", "bfloat16"):
        a, x = _scan_inputs(cuda_device, 2, 700, 300, dtype, 5)
        a.requires_grad_()
        x.requires_grad_()
        g = torch.randn(a.shape, generator=torch.Generator().manual_seed(6)
                        ).to(cuda_device, a.dtype)
        for _ in range(3):
            f0, b0 = rglru_scan_fwd.launches, rglru_scan_bwd.launches
            got = torch.autograd.grad(rglru_scan(a, x), (a, x), g)
            assert (rglru_scan_fwd.launches - f0,
                    rglru_scan_bwd.launches - b0) == (1, 1)
        want = torch.autograd.grad(rglru_scan_reference(a, x), (a, x), g)
        for u, w in zip(got, want):
            assert torch.equal(_bits(u), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m",
                                  "recurrentgemma-2b"])
def test_family_train_steps_are_deterministic_on_card(cuda_device, arch):
    """Reduced widths at f32 (granite-moe at head_dim 64; xLSTM with
    mlstm_chunk 16, so its chunked form and cummax run), three train
    steps twice under torch.use_deterministic_algorithms(True): the MoE
    gathers' backward, xLSTM's prefix sums (B4 at a = 1) and the RG-LRU
    scan's backward raise nothing, two runs are bitwise equal, and the
    losses are within 1e-4 of the CPU's."""
    from repro_torch.train import (DataConfig, SyntheticLM, TrainConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.tree import tree_map, tree_paths
    over = {"compute_dtype": "float32"}
    if arch == "granite-moe-1b-a400m":
        over["head_dim"] = 64
    if arch == "xlstm-350m":
        over["mlstm_chunk"] = 16
    cfg = registry.get_reduced_config(arch, **over)
    fns = registry.model_fns(cfg)
    step = make_train_step(cfg, fns, TrainConfig(warmup_steps=2,
                                                 total_steps=8))
    first = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                             "cpu")

    def run(dev):
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=64, global_batch=4), dev)
        state, losses = tree_map(lambda t: t.to(dev), first), []
        for i in range(3):
            state, m = step(state, data.batch_at(i))
            losses.append(m["loss"].item())
        return losses, tree_paths(tree_map(lambda t: t.cpu(), state))
    torch.use_deterministic_algorithms(True)
    try:
        (l1, s1), (l2, s2) = run(cuda_device), run(cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    assert l1 == l2 and all(torch.equal(s1[k], s2[k]) for k in s1)
    np.testing.assert_allclose(l1, run(torch.device("cpu"))[0], rtol=1e-4)


@pytest.mark.cuda
def test_rglru_scan_kernel_properties_and_gradients(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 300, 130, generator=g).to(cuda_device)
    assert torch.equal(rglru_scan(torch.zeros_like(x), x), x)
    xi = torch.randint(-8, 9, (2, 300, 130), generator=g).float().to(
        cuda_device)
    assert torch.equal(rglru_scan(torch.ones_like(xi), xi),
                       rglru_scan_reference(torch.ones_like(xi), xi))
    torch.testing.assert_close(rglru_scan(torch.ones_like(xi), xi),
                               xi.cumsum(1), atol=0, rtol=0)
    a = torch.empty(1, 128, 128).uniform_(0.5, 0.99, generator=g).to(
        cuda_device).requires_grad_()
    x = torch.randn(1, 128, 128, generator=g).to(cuda_device).requires_grad_()
    go = torch.randn(1, 128, 128, generator=g).to(cuda_device)
    got = torch.autograd.grad(rglru_scan(a, x), (a, x), go)
    want = torch.autograd.grad(rglru_scan_reference(a, x), (a, x), go)
    for u, w in zip(got, want):
        torch.testing.assert_close(u, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_rglru_engine_on_card_through_the_kernels(cuda_device):
    """recurrentgemma reduced widths at d_model 256, 4 heads (head_dim 64,
    a B1 instance), f32: B4 launched once per recurrent block per prefill
    call, B1 once per attention block per sub-step; decode_block 1 == 8."""
    cfg = registry.get_reduced_config("recurrentgemma-2b", d_model=256,
                                      compute_dtype="float32")
    fns = registry.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 40, 6)]
    calls = []
    streams = []
    for block in (1, 8):
        eng = ServingEngine(cfg, fns, params,
                            EngineConfig(max_batch=3, max_len=64, seed=7,
                                         decode_block=block))
        prefill = eng.spec.prefill
        eng.spec.prefill = lambda *a, **k: calls.append(1) or prefill(*a,
                                                                       **k)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=9,
                               temperature=3.0 if uid % 2 else 0.0))
        calls.clear()
        before = (rglru_scan_fwd.launches, decode_attention.launches)
        done = eng.run()
        rec = 2 * cfg.n_groups + cfg.n_tail_rec
        assert rglru_scan_fwd.launches - before[0] == rec * len(calls)
        assert decode_attention.launches - before[1] == \
            cfg.n_groups * eng.stats["decode_blocks"] * block
        streams.append({r.uid: r.generated for r in done})
    assert streams[0] == streams[1]
    assert all(len(v) == 9 for v in streams[0].values())


@pytest.mark.cuda
def test_moe_ffn_on_the_card_takes_no_host_sync_and_repeats_bitwise(
        cuda_device):
    """The MoE dispatch (sort, searchsorted, gathers) at granite-moe's
    decode shape (T 16, E 32, k 8, bf16) under sync debug mode "error";
    two calls bitwise equal (no atomics); f32 within 2e-5 of the CPU."""
    from repro_torch.models.moe import moe_ffn
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 256, generator=g)
    p = {"router": torch.randn(256, 32, generator=g),
         "wi_gate": torch.randn(32, 256, 64, generator=g) * 0.06,
         "wi_up": torch.randn(32, 256, 64, generator=g) * 0.06,
         "wo": torch.randn(32, 64, 256, generator=g) * 0.12}
    kw = dict(num_experts=32, top_k=8)
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(cuda_device, dt)
        pd = {k: v.to(cuda_device, dt) for k, v in p.items()}
        with no_host_sync(cuda_device):
            a = moe_ffn(xd, pd, **kw)
            b = moe_ffn(xd, pd, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), moe_ffn(x, p, **kw), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m"])
def test_moe_and_xlstm_engines_on_card_equal_the_cpu(cuda_device, arch):
    """Reduced widths (MoE at head_dim 64, which B1 takes), f32: the
    card's token streams equal the CPU's, decode_block 1 == 8."""
    over = {"compute_dtype": "float32"}
    if arch != "xlstm-350m":
        over["head_dim"] = 64
    cfg = registry.get_reduced_config(arch, **over)
    fns = registry.model_fns(cfg)
    cpu = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 40, 6)]
    streams = []
    for dev, block in (("cpu", 4), (cuda_device, 1), (cuda_device, 8)):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in cpu.items()}
        eng = ServingEngine(cfg, fns, params,
                            EngineConfig(max_batch=3, max_len=64, seed=7,
                                         decode_block=block))
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=9,
                               temperature=3.0 if uid % 2 else 0.0))
        streams.append({r.uid: r.generated for r in eng.run()})
    assert streams[0] == streams[1] == streams[2]
    assert all(len(v) == 9 for v in streams[0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, None])
@pytest.mark.parametrize("arch", ["minicpm-2b", "stablelm-12b",
                                  "command-r-35b", "qwen2.5-32b",
                                  "qwen2-vl-2b", "musicgen-medium"])
def test_new_transformer_branches_on_card_equal_the_cpu(cuda_device, arch,
                                                        head_dim):
    """Reduced widths at head_dim 64 and at their own (None: 12, 16 or
    20, which the kernels run zero-padded to 64), f32: the training
    forward (B3) and a prefill + decode (B1) on the card within 1e-3 of
    the CPU; the token LMs' engine streams equal the CPU's."""
    if head_dim is None:
        cfg = registry.get_reduced_config(arch, compute_dtype="float32")
    else:
        cfg = registry.get_reduced_config(arch, compute_dtype="float32",
                                          head_dim=64)
    if cfg.mrope_sections and head_dim:
        cfg = registry.get_reduced_config(arch, compute_dtype="float32",
                                          head_dim=64,
                                          mrope_sections=(16, 8, 8))
    fns = registry.model_fns(cfg)
    cpu = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(cuda_device))
           for k, v in cpu.items()}
    rng = np.random.default_rng(1)
    shape = (2, cfg.n_codebooks, 16) if cfg.n_codebooks > 1 else (2, 16)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    want = fns.forward(cpu, toks, cfg)
    got = fns.forward(gpu, toks.to(cuda_device), cfg)
    assert (got.cpu() - want).abs().max().item() <= 1e-3
    logits = {}
    for dev, p in (("cpu", cpu), (cuda_device, gpu)):
        cache = fns.init_cache(cfg, 2, 64, device=dev)
        cache["pos"] = torch.zeros(2, dtype=torch.int32, device=dev)
        out, cache = fns.decode_step(p, cache, toks.to(dev), cfg)
        step, _ = fns.decode_step(p, cache, toks[..., :1].to(dev), cfg)
        logits[str(dev)] = (out.cpu(), step.cpu())
    for a, b in zip(logits["cpu"], logits[str(cuda_device)]):
        assert (a - b).abs().max().item() <= 1e-3
    if cfg.n_codebooks > 1 or cfg.mrope_sections:
        return                      # trained only: no engine serves them
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 40, 6)]
    streams = []
    for dev, p, page in (("cpu", cpu, 0), (cuda_device, gpu, 0),
                         (cuda_device, gpu, 16)):
        eng = ServingEngine(cfg, fns, p, EngineConfig(
            max_batch=3, max_len=64, seed=7, decode_block=4, page_size=page))
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=9,
                               temperature=3.0 if uid % 2 else 0.0))
        streams.append({r.uid: r.generated for r in eng.run()})
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_sdc_flips_on_the_card_equal_the_cpu(cuda_device, dtype):
    """The SDC injector's flips of one key land on the same bits on the
    card as on the CPU: a leaf of a few elements with many colliding draws
    and a tree of wide leaves, compared as bit patterns."""
    from repro_torch.core.radiation.injection import (
        _BITS_FOR, count_changed_elements, flip_bits, inject_tree)
    from repro_torch.serving import prng
    dt = getattr(torch, dtype)
    view = _BITS_FOR[dt][0]
    g = torch.Generator().manual_seed(3)
    small = torch.randn(3, generator=g).to(dt)
    cpu = flip_bits(prng.PRNGKey(4), small, 100)
    card = flip_bits(prng.PRNGKey(4), small.to(cuda_device), 100)
    assert torch.equal(cpu.view(view), card.cpu().view(view))
    tree = {"w": torch.randn(300, 64, generator=g).to(dt),
            "inner": {"b": torch.randn(17, generator=g).to(dt)}}
    cpu = inject_tree(prng.PRNGKey(5), tree, 400)
    card = inject_tree(prng.PRNGKey(5), {"w": tree["w"].to(cuda_device),
                                         "inner": {"b": tree["inner"]["b"]
                                                   .to(cuda_device)}}, 400)
    for a, b, orig in ((cpu["w"], card["w"], tree["w"]),
                       (cpu["inner"]["b"], card["inner"]["b"],
                        tree["inner"]["b"])):
        assert torch.equal(a.view(view), b.cpu().view(view))
        assert count_changed_elements(a, orig) == count_changed_elements(
            b, orig.to(cuda_device))
