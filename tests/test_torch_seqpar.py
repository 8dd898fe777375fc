"""The pieces of sequence parallelism on "model", on the CPU (plain
versions; the CUDA kernels run in chip_smoke.py phase 26):

  - B1 with its log-sum-exp: the plain version's lse, the slices'
    partials merged (`merge_partials`) equal to the whole cache's plain
    attention and the reference's oracle, exact zeros where every slice
    is empty;
  - B3 at a query offset: the plain version equal to the reference's
    `attention_ref` at the same offset, forward and gradients through
    the wrapper; the CUDA kernel's tiled algorithm equal to it at offsets
    on and off the tile grid; the fake count's visible pairs exact;
  - the sLSTM's fake path: its FLOPs equal to what FlopCounterMode
    counts through the loop, forward and backward;
  - the dry run's byte count on one matmul and one kernel's fake call,
    the grouping of `op_memory`'s per-op workspace, and the reduced cells of the sequence-parallel layouts and of
    xlstm-350m's train_4k and prefill_32k on a fake (2, 4, 4) group."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention_reference as j_decode  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import _boundary  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_reference, merge_partials)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _fake_fwd, fake_flops, visible_pairs)
from repro_torch.kernels.flash_attention.ref import \
    tiled_attention_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("h,hkv", [(6, 6), (8, 2)])
@pytest.mark.parametrize("n_slices", [2, 4])
def test_merged_slices_equal_the_whole_cache(h, hkv, n_slices):
    rng = np.random.default_rng(h * 10 + n_slices)
    b, m, dh = 6, 64, 16
    q, k, v = _rand(rng, b, h, dh), _rand(rng, b, m, hkv, dh), \
        _rand(rng, b, m, hkv, dh)
    # empty; inside slice 0; on a boundary; ragged; full
    lens = np.array([0, 3, m // n_slices, 37, m - 1, m], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = torch.from_numpy(lens)
    whole = decode_attention_reference(tq, tk, tv, tl)
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens)))
    sl = m // n_slices
    outs, lses = [], []
    for r in range(n_slices):
        local = (tl - r * sl).clamp(0, sl)
        o, lse = decode_attention(tq, tk[:, r * sl:(r + 1) * sl],
                                  tv[:, r * sl:(r + 1) * sl], local,
                                  return_lse=True)
        empty = local == 0
        assert bool((o[empty] == 0).all())
        assert bool((lse[empty] == -torch.inf).all())
        outs.append(o)
        lses.append(lse)
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    assert merged.dtype == torch.float32
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(merged.numpy(), want, atol=1e-5, rtol=1e-5)
    assert bool((merged[0] == 0).all())     # every slice empty: exact 0


def test_decode_lse_is_the_log_sum_exp_of_the_scaled_scores():
    rng = np.random.default_rng(3)
    b, h, m, dh = 3, 4, 20, 8
    q, k, v = (torch.from_numpy(a) for a in (
        _rand(rng, b, h, dh), _rand(rng, b, m, h, dh),
        _rand(rng, b, m, h, dh)))
    lens = torch.tensor([0, 7, 20], dtype=torch.int32)
    out, lse = decode_attention_reference(q, k, v, lens, return_lse=True)
    s = torch.einsum("bhd,bmhd->bhm", q, k) * dh ** -0.5
    for i, n in enumerate(lens.tolist()):
        want = torch.logsumexp(s[i, :, :n], -1) if n else \
            torch.full((h,), -torch.inf)
        torch.testing.assert_close(lse[i], want, rtol=1e-6, atol=1e-6)


def _qkv(seed, b, sq, skv, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, h, dh), _rand(rng, b, skv, hkv, dh),
            _rand(rng, b, skv, hkv, dh))


OFFSETS = [(8, 40, 0), (8, 40, 5), (16, 16, 0), (8, 40, 32), (1, 9, 8)]


@pytest.mark.parametrize("sq,skv,off", OFFSETS)
def test_flash_plain_at_an_offset_equals_the_reference(sq, skv, off):
    q, k, v = _qkv(sq + off, 2, sq, skv, 4, 2, 16)
    want = np.asarray(jl.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       q_offset=off))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    plain = attention_reference(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), causal=True,
                                q_offset=off).transpose(1, 2)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sq,skv,off", OFFSETS[:4])
def test_flash_gradients_at_an_offset_equal_the_reference(sq, skv, off):
    q, k, v = _qkv(7 + off, 2, sq, skv, 4, 2, 16)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jl.attention_ref(*a, causal=True, q_offset=off) * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, causal=True, q_offset=off)
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("sq,skv,off", [(200, 700, 0), (200, 700, 64),
                                        (200, 700, 300), (130, 400, 128),
                                        (256, 256, 0)])
def test_tiled_algorithm_at_an_offset(sq, skv, off):
    """The bf16 kernel's tiles at an offset on the 128-key grid (the
    diagonal in one tile) and off it (across two), in f32."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(off + 1, 1, sq, skv, 2, 1, 16))
    got = tiled_attention_reference(q, k, v, causal=True, q_offset=off)
    want = attention_reference(q, k, v, causal=True, q_offset=off)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("sq,skv,off", [(7, 7, 0), (5, 20, 0), (5, 20, 6),
                                        (5, 20, 15), (9, 9, 3), (4, 6, 0)])
def test_fake_count_is_the_visible_pairs(sq, skv, off):
    mask = torch.ones(sq, skv, dtype=torch.bool).tril(off)
    assert visible_pairs(sq, skv, True, off) == int(mask.sum())
    assert visible_pairs(sq, skv, False, off) == sq * skv
    assert fake_flops(2, 3, sq, skv, 8, True, off) == \
        4 * 8 * 2 * 3 * int(mask.sum())


def test_fake_call_in_a_query_split_counts_every_rank():
    from torch._subclasses.fake_tensor import FakeTensorMode
    _boundary.reset_counts()
    sl, ms = 4, 4
    with FakeTensorMode():
        q = torch.empty(1, 2, sl, 8)
        k = torch.empty(1, 2, sl * ms, 8)
        _boundary._SPLIT.append([j * sl for j in range(ms)])   # rank 0's
        try:
            _fake_fwd(q, k, k, True, 0)
        finally:
            _boundary._SPLIT.pop()
    c = _boundary.COUNTS["flash_attention"]
    want = [fake_flops(1, 2, sl, sl * ms, 8, True, j * sl)
            for j in range(ms)]
    assert c["flops_by_model_rank"] == want and c["flops"] == want[0]
    assert want == sorted(want) and want[0] < want[-1]
    _boundary.reset_counts()


def test_slstm_fake_path_counts_the_loop():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import LocalFlopCounter
    from repro_torch.models.xlstm import _slstm_scan
    b, s, h, dh = 2, 5, 4, 8
    fc = LocalFlopCounter()
    with fc:
        r = torch.randn(h, 4, dh, dh, requires_grad=True)
        gx = torch.randn(b, s, 4, h, dh, requires_grad=True)
        hs, carry = _slstm_scan(r, gx)
        (hs.sum() + sum(c.sum() for c in carry)).backward()
    _boundary.reset_counts()
    with FakeTensorMode():
        r = torch.empty(h, 4, dh, dh, requires_grad=True)
        gx = torch.empty(b, s, 4, h, dh, requires_grad=True)
        hs, carry = _slstm_scan(r, gx)
        assert hs.shape == (b, s, h, dh)
        assert [c.shape for c in carry] == [(b, h, dh)] * 4
        (hs.sum() + sum(c.sum() for c in carry)).backward()
        assert r.grad.shape == r.shape and gx.grad.shape == gx.shape
    c = _boundary.COUNTS["slstm_scan"]
    assert c["calls"] == 2 and c["flops"] == fc.flops > 0
    _boundary.reset_counts()


def test_byte_count_of_a_matmul_and_a_kernel_fake_call():
    """`measure` on fake tensors: one (m, k) x (k, n) f32 matmul reads
    both operands and writes its product; a fake B3 call adds its own
    bytes (q, k, v read, out written)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import measure
    m, kk, n = 32, 48, 16
    with FakeTensorMode():
        a, b = torch.empty(m, kk), torch.empty(kk, n)
        q = torch.empty(2, 16, 4, 8, dtype=torch.bfloat16)
        kv = torch.empty(2, 16, 2, 8, dtype=torch.bfloat16)
        r = measure(lambda: (a @ b, flash_attention(q, kv, kv)), (),
                    "fake")
    assert r["bytes"]["aten"] == 4 * (m * kk + kk * n + m * n)
    assert r["bytes"]["kernels"] == 2 * (2 * q.numel() + 2 * kv.numel())
    assert r["bytes"]["total"] == r["bytes"]["aten"] + r["bytes"]["kernels"]


def test_op_workspace_groups_ops_by_what_they_held_inside():
    """`op_memory.OpWorkspace.by_op`: calls of one op at one set of
    shapes count together under the most any of them held inside; the
    op that held the most comes first.  (The mode itself reads the
    card's allocator.)"""
    from repro_torch.analysis.op_memory import OpWorkspace
    ws = OpWorkspace()
    big, small = (((4, 8), "float32"),), (((2,), "float32"),)
    ws.rows = [(0, "aten.mm", small, 0, 0, 0),
               (1 << 30, "aten._softmax_backward_data", big, 0, 0, 0),
               (1 << 20, "aten._softmax_backward_data", big, 0, 0, 0),
               (8, "aten.mm", small, 0, 0, 0)]
    assert ws.by_op() == [("aten._softmax_backward_data", big, 2, 1 << 30),
                          ("aten.mm", small, 2, 8)]
    assert ws.by_op(1) == ws.by_op()[:1]


CELLS = [("minicpm-2b", "decode_32k"), ("minicpm-2b", "prefill_32k"),
         ("xlstm-350m", "train_4k"), ("xlstm-350m", "prefill_32k")]
CODE = """
import json, sys, time
from repro_torch.launch import dryrun
out = {}
for arch, shape in %r:
    t0 = time.perf_counter()
    r = dryrun.run_cell(arch, shape, True, sys.argv[1], verbose=False,
                        mesh_shape=(2, 4, 4), reduced=True, dims=(64, 16))
    r["wall_s"] = time.perf_counter() - t0
    out[arch + "/" + shape] = r
print(json.dumps(out))
""" % (CELLS,)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("seqcells")
    proc = subprocess.run(
        [sys.executable, "-c", CODE, str(out)], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-6000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_reduced_cell_has_a_measured_roofline(cells, cell):
    r = cells[cell]
    roof = r["roofline"]
    assert r["bytes"]["total"] > 0
    assert roof["compute_s"] > 0 and roof["memory_s"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])


def test_decode_cell_holds_a_slice_of_the_cache(cells):
    r = cells["minicpm-2b/decode_32k"]
    rows = r["kv_cache_bytes"] // (r["mesh"]["pod"] * r["mesh"]["data"])
    assert r["kv_cache_bytes_per_rank"] * r["mesh"]["model"] == rows
    assert r["flops"]["per_kernel"]["decode_attention"]["calls"] == 2
    assert r["query_offset"] is None


def test_prefill_cell_counts_every_model_rank(cells):
    """6 heads on 4 model ranks: q sequence-sharded, rank 0's query rows
    at offset 0 do the least causal work; the ranks' kernel FLOPs grow
    with their offsets and sum to the whole causal attention."""
    r = cells["minicpm-2b/prefill_32k"]
    fl = r["flops"]
    assert r["query_offset"] == 0
    per = fl["kernels_by_model_rank"]
    assert len(per) == 4 and per == sorted(per) and per[0] < per[-1]
    assert per[0] == fl["kernels"]
    assert fl["kernels_heaviest_model_rank"] == per[-1]
    assert fl["kernels_mean_model_rank"] == sum(per) / 4
    # the whole sequence's causal pairs: 2 layers, 6 heads, 16 rows over
    # 2 x 4 batch ranks
    from repro_torch.models import registry
    cfg = registry.get_reduced_config("minicpm-2b")
    assert sum(per) == cfg.n_layers * fake_flops(2, cfg.n_heads, 64, 64,
                                                 cfg.hd, True, 0)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_xlstm_cells_finish_without_walking_positions(cells, shape):
    r = cells[f"xlstm-350m/{shape}"]
    k = r["flops"]["per_kernel"]["slstm_scan"]
    assert k["calls"] > 0 and k["flops"] > 0
    assert r["wall_s"] < 60
    assert not math.isnan(r["roofline"]["memory_s"])
