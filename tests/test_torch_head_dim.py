"""The attention kernels' padded small head dims (`kernels/_head_dim.py`),
on the CPU: the reduced configs' dh 8, 12, 16 and 20 run on the dh-64
instances, zero-padded, at the true dh's softmax scale.

The kernels themselves run only on the card (tests/test_torch_cuda.py
holds them against their plain versions at these dims); here:
  - the padded function equals the unpadded one (zero columns add nothing
    to q.k; padded columns of v are sliced away), f32 within 1e-6;
  - each wrapper (B1, B2, B3) hands its C launcher tensors padded to 64,
    head dim 64 and the scale dh**-0.5, and returns the true width in its
    documented layout: the launchers are replaced by recorders and the
    device checks by a recorder of what they were given."""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _head_dim  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402

torch.set_num_threads(1)
REDUCED = [8, 12, 16, 20]


def test_instances_and_padding_rule():
    for dh in (64, 128, 160):
        assert _head_dim.instance_head_dim(dh, fa._HEAD_DIMS, "x") == dh
    for dh in REDUCED + [1, 63]:
        assert _head_dim.instance_head_dim(dh, fa._HEAD_DIMS, "x") == 64
        assert _head_dim.instance_head_dim(dh, da._HEAD_DIMS, "x") == 64
    for dh in (0, 96, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            _head_dim.instance_head_dim(dh, fa._HEAD_DIMS, "flash")
    t = torch.randn(2, 3, 12)
    p = _head_dim.pad_head_dim(t, 64)
    assert p.shape == (2, 3, 64) and torch.equal(p[..., :12], t)
    assert not p[..., 12:].any()
    assert _head_dim.pad_head_dim(t, 12) is t


def _attend(q, k, v, scale):
    """softmax(q k^T * scale) v, (B, H, S, dh) with k/v heads repeated."""
    rep = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    return torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v


@pytest.mark.parametrize("dh", REDUCED)
def test_padded_attention_is_the_same_function(dh):
    g = torch.Generator().manual_seed(dh)
    q, k, v = (torch.randn(2, n, 33, dh, generator=g) for n in (4, 2, 2))
    want = _attend(q, k, v, dh ** -0.5)
    qp, kp, vp = (_head_dim.pad_head_dim(x, 64) for x in (q, k, v))
    got = _attend(qp, kp, vp, dh ** -0.5)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh], want, atol=1e-6, rtol=1e-6)


class _Recorder:
    """Stands in for a kernel library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def load(self):
        def launch(name):
            def record(*args):
                self.calls.append((name, args))
                return 0
            return record
        return types.SimpleNamespace(
            flash_attention_launch=launch("flash"),
            decode_attention_launch=launch("dense"),
            paged_decode_attention_launch=launch("paged"),
            decode_attention_workspace=lambda *a: 8)


@pytest.fixture
def recorded(monkeypatch):
    """(library recorder, shapes the device checks were given).  The
    flash wrapper's device query (the card's L2 size, for its band rule)
    stands in for a card too."""
    lib, checked = _Recorder(), []
    for mod in (fa, da):
        monkeypatch.setattr(mod, "LIBRARY", lib)
        monkeypatch.setattr(mod, "_check", lambda *ts, **kw: checked.append(
            [tuple(t.shape) for t in ts[:3]]))
    monkeypatch.setattr(fa, "_l2_bytes", lambda device: 50 << 20)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib, checked


@pytest.mark.parametrize("dh", REDUCED)
def test_flash_wrapper_pads_to_64_with_the_true_scale(recorded, dh):
    lib, checked = recorded
    q = torch.randn(2, 4, 40, dh).bfloat16()
    k = v = torch.randn(2, 2, 40, dh).bfloat16()
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    assert checked == [[(2, 4, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)]]
    (name, args), = lib.calls
    assert name == "flash"
    b, h, group, sq, skv, run_dh, dtype, causal, scale = args[5:14]
    assert (b, h, group, sq, skv, run_dh, causal) == (2, 4, 2, 40, 40, 64, 1)
    assert scale == dh ** -0.5
    assert out.shape == (2, 4, 40, dh) and out.dtype == torch.bfloat16
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("dh", REDUCED)
def test_decode_wrappers_pad_cache_and_pool_to_64(recorded, dh):
    lib, checked = recorded
    q = torch.randn(3, 4, dh)
    kc = torch.randn(3, 32, 2, dh)
    lens = torch.tensor([0, 5, 32], dtype=torch.int32)
    out = da.decode_attention_fwd(q, kc, kc, lens)
    pool = torch.randn(7, 16, 2, dh)
    ptab = torch.tensor([[0, 1], [2, 3], [4, 6]], dtype=torch.int32)
    paged = da.paged_decode_attention_fwd(q, pool, pool, ptab, lens)
    assert checked == [[(3, 4, 64), (3, 32, 2, 64), (3, 32, 2, 64)],
                       [(3, 4, 64), (7, 16, 2, 64), (7, 16, 2, 64)]]
    (dense_name, dense), (paged_name, pargs) = lib.calls
    assert (dense_name, paged_name) == ("dense", "paged")
    assert dense[6:12] == (3, 2, 2, 32, 64, 0) and dense[12] == dh ** -0.5
    assert pargs[7:14] == (3, 2, 2, 16, 2, 64, 0) and pargs[14] == dh ** -0.5
    for o in (out, paged):
        assert o.shape == (3, 4, dh) and o.is_contiguous()
