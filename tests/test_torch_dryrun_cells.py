"""The port's dry-run cells at reduced size: one cell of each family on a
fake (2, 4, 4) process group of 32 ranks, rank 0's program run on fake
tensors (nothing allocated): the dense transformer's train step (with
the flash kernel's fake calls counted), and the MoE, xLSTM and RG-LRU
families' decode steps against their serving caches.  Each cell reports
peak memory by category, its FLOPs (the aten ops plus the kernels'
counts), the collectives of its own program and the analytic roofline.
The full-width cells (`--all`) run in minutes each and are not run
here."""
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

CODE = """
import json, sys
from repro_torch.launch import dryrun
out = {}
for arch, shape in %r:
    r = dryrun.run_cell(arch, shape, True, sys.argv[1], verbose=False,
                        mesh_shape=(2, 4, 4), reduced=True, dims=(64, 16))
    out[arch] = r
print(json.dumps(out))
""" % (CELLS,)


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
    r = cells[arch]
    assert r["device"] == "fake" and r["reduced"]
    assert r["mesh"] == {"pod": 2, "data": 4, "model": 4}
    assert r["chips"] == 32 and r["shape"] == shape
    assert r["memory_peak_bytes"] > 0 and r["flops"]["total"] > 0
    assert r["collectives"]["wire_bytes"] > 0
    assert r["collectives_loop_aware"]["unknown_loops"] == []
    assert r["analytic"]["flops_per_device"] > 0


def test_train_cell_counts_the_flash_kernel(cells):
    k = cells["suncatcher-lm-100m"]["flops"]["per_kernel"]
    # two layers, each a forward and the remat's recompute
    assert k["flash_attention"]["calls"] == 4
    assert k["flash_attention"]["flops"] > 0


def test_decode_cells_count_their_kernels(cells):
    assert cells["granite-moe-1b-a400m"]["flops"]["per_kernel"][
        "decode_attention"]["calls"] == 2
    # the RG-LRU attention blocks decode through B1; xLSTM runs no kernel
    # at decode
    assert "decode_attention" in cells["recurrentgemma-2b"]["flops"][
        "per_kernel"]
    assert "notes" in cells["granite-moe-1b-a400m"]
