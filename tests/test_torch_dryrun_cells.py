"""The port's dry-run cells at reduced size: one cell of each family on a
fake (2, 4, 4) process group of 32 ranks, rank 0's program run on fake
tensors (nothing allocated): the dense transformer's train step (with
the flash kernel's fake calls counted), the MoE, xLSTM and RG-LRU
families' decode steps against their serving caches, and the RG-LRU
family's windowed prefill at 4,096 tokens through `attention_chunked`
(the dry run's attn_impl, which a config of a family that reads it must
carry).  Each cell reports peak memory by category, its FLOPs (the aten
ops plus the kernels' counts), the collectives of its own program, in
total and by the line of the port that issued them, and the analytic
roofline.  The full-width cells (`--all`) run in minutes each and are
not run here."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("suncatcher-lm-100m", "train_4k"),
         ("granite-moe-1b-a400m", "decode_32k"),
         ("xlstm-350m", "decode_32k"),
         ("recurrentgemma-2b", "decode_32k")]

# recurrentgemma's windowed prefill at 4,096 tokens: eight 512-position KV
# blocks through attention_chunked
PREFILL = ("recurrentgemma-2b", "prefill_32k", (4096, 16))

CODE = """
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models import layers
calls = {}

def spy(name):
    fn = getattr(layers, name)

    def counted(q, *args, **kwargs):
        if q.shape[1] > 1:                    # a multi-row call
            calls[name] = calls.get(name, 0) + 1
        return fn(q, *args, **kwargs)
    setattr(layers, name, counted)

spy("attention_chunked")
spy("attention_ref")
out = {}
for arch, shape, dims in [(a, s, (64, 16)) for a, s in %r] + [%r]:
    calls.clear()
    r = dryrun.run_cell(arch, shape, True, sys.argv[1], verbose=False,
                        mesh_shape=(2, 4, 4), reduced=True, dims=dims)
    r["attention_calls"] = dict(calls)
    out[f"{arch} {shape}"] = r
print(json.dumps(out))
""" % (CELLS, PREFILL)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    proc = subprocess.run(
        [sys.executable, "-c", CODE, str(out)], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-6000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS, ids=[a for a, _ in CELLS])
def test_reduced_cell_runs_fake_on_a_2x4x4_group(cells, arch, shape):
    r = cells[f"{arch} {shape}"]
    assert r["device"] == "fake" and r["reduced"]
    assert r["mesh"] == {"pod": 2, "data": 4, "model": 4}
    assert r["chips"] == 32 and r["shape"] == shape
    assert r["memory_peak_bytes"] > 0 and r["flops"]["total"] > 0
    assert r["collectives"]["wire_bytes"] > 0
    assert r["collectives_loop_aware"]["unknown_loops"] == []
    assert r["analytic"]["flops_per_device"] > 0


def test_train_cell_counts_the_flash_kernel(cells):
    k = cells["suncatcher-lm-100m train_4k"]["flops"]["per_kernel"]
    # two layers, each a forward and the remat's recompute
    assert k["flash_attention"]["calls"] == 4
    assert k["flash_attention"]["flops"] > 0


def test_decode_cells_count_their_kernels(cells):
    assert cells["granite-moe-1b-a400m decode_32k"]["flops"]["per_kernel"][
        "decode_attention"]["calls"] == 2
    # the RG-LRU attention blocks decode through B1; xLSTM runs no kernel
    # at decode
    assert "decode_attention" in cells["recurrentgemma-2b decode_32k"]["flops"][
        "per_kernel"]
    # the KV cache shards its length over "model" as the reference's dry
    # run places it: each rank holds 1 / model of the whole cache
    r = cells["granite-moe-1b-a400m decode_32k"]
    assert "notes" not in r
    rows = r["kv_cache_bytes"] // (r["mesh"]["pod"] * r["mesh"]["data"])
    assert r["kv_cache_bytes_per_rank"] * r["mesh"]["model"] == rows


def test_collective_sites_sum_to_the_totals(cells):
    """`collectives.by_site`: each collective under the line of the port
    that issued it; per kind the sites' bytes and counts are the totals,
    and their wire bytes the total wire."""
    for r in cells.values():
        c = r["collectives"]
        assert c["by_site"]
        for kind in c["bytes"]:
            sites = [v for k, v in c["by_site"].items()
                     if k.startswith(kind + " @ ")]
            assert sum(v["bytes"] for v in sites) == c["bytes"][kind]
            assert sum(v["counts"] for v in sites) == c["counts"][kind]
        assert sum(v["wire_bytes"] for v in c["by_site"].values()) == \
            c["wire_bytes"]
        assert all(" @ autograd" not in k or k.endswith("[backward]")
                   for k in c["by_site"])


def test_rglru_prefill_cell_runs_the_chunked_attention(cells):
    """The dry run sets attn_impl="chunked" on the RG-LRU family as the
    reference's does: the windowed prefill reaches attention_chunked
    (one call a local-attention layer), never attention_ref, and the
    rank's peak stays below the one f32 score tensor attention_ref would
    hold: 2 local rows x 1 local head (4 heads over "model" 4) x 4,096^2."""
    r = cells["recurrentgemma-2b prefill_32k"]
    assert r["attn_impl"] == "chunked" and r["seq_len"] == 4096
    assert r["attention_calls"] == {"attention_chunked": 1}
    score = 2 * 1 * 4096 * 4096 * 4
    assert 0 < r["memory_peak_bytes"] < score
    assert cells["suncatcher-lm-100m train_4k"]["attn_impl"] == "chunked"
    assert cells["xlstm-350m decode_32k"]["attn_impl"] is None


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "stablelm-12b"])
def test_build_refuses_a_config_without_attn_impl(arch, monkeypatch):
    """A config of a family that reads attn_impl but lacks the field
    fails the build instead of running attention_ref."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    cfg = registry.get_reduced_config(arch)
    stripped = dataclasses.make_dataclass(
        "Stripped", [(f.name, f.type, dataclasses.field(
            default=getattr(cfg, f.name))) for f in dataclasses.fields(cfg)
            if f.name != "attn_impl"], frozen=True)
    monkeypatch.setitem(registry._FAMILIES, stripped, registry.family(cfg))
    monkeypatch.setattr(registry, "get_reduced_config",
                        lambda a, **over: dataclasses.replace(stripped(),
                                                              **over))
    with pytest.raises(TypeError, match="attn_impl"):
        dryrun.build_cell(arch, "prefill_32k", None, False, reduced=True,
                          dims=(64, 16))
