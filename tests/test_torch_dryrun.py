"""The port's dry run of the DiLoCo outer sync (`python -m
repro_torch.launch.dryrun --outer-sync`): rank 0 of the (2, 16, 16)
production mesh on a fake process group of 512 ranks, the demo LM at
full width, nothing allocated.

  - Per-rank bytes by op and dtype equal the reference's checked-in
    dry run (benchmarks/results/dryrun/diloco_outer_*_multi.json): the
    int8 hop all-gathers s8 824,832 + f32 12,888 B, top-k f32 32,968 +
    s32 32,968 B, the uncompressed sync all-reduces f32 1,649,664 B.
  - `--check` compares like for like: the per-pod payload (one rank's
    own bytes times a pod's 256 ranks) against the per-pod prediction.
    The honest payloads pass (1.049x); one planted at 2.5x fails.  The
    reference's gate compares a device's gathered bytes with a pod's
    payload (ROADMAP C12).
  - `analysis.refresh` rewrites a cell JSON's analytic block in place;
    the paper runner's `roofline` entry reads the JSONs, and says so
    when there are none.
  - The dry run's memory count leaves out tensors made under another
    fake mode (DTensor's shape inference) on any torch version, and
    `measure` refuses to run where its shape-inference hook is missing.
Process groups are global to a process: the dry run runs in
subprocesses."""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch.dryrun import check_outer_sync  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "benchmarks" / "results" / "dryrun"
MODES = ("none", "int8", "topk")


@pytest.fixture(scope="module")
def outer(tmp_path_factory):
    """The three outer-sync cells, as three concurrent CLI runs with
    --check."""
    out = tmp_path_factory.mktemp("outer")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--outer-sync",
         "--compress", m, "--check", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for m in MODES}
    results = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        with open(out / f"diloco_outer_suncatcher-lm-100m_{m}_multi.json") \
                as f:
            results[m] = json.load(f)
        results[m]["stdout"] = stdout
    return results


@pytest.mark.parametrize("mode", MODES)
def test_outer_sync_per_rank_bytes_equal_the_reference(outer, mode):
    with open(REF / f"diloco_outer_suncatcher-lm-100m_{mode}_multi.json") \
            as f:
        ref = json.load(f)
    got = outer[mode]["collectives"]
    assert got["bytes_by_dtype"] == ref["collectives"]["bytes_by_dtype"]
    assert got["counts"] == ref["collectives"]["counts"]
    assert outer[mode]["predicted_outer_wire_bytes_per_pod"] == \
        ref["predicted_outer_wire_bytes_per_pod"]
    assert outer[mode]["device"] == "fake"


@pytest.mark.parametrize("mode", MODES)
def test_outer_sync_check_is_like_for_like(outer, mode):
    r = outer[mode]
    per_rank_own = r["collectives"]["bytes"].get("all-gather", 0) // 2 + \
        r["collectives"]["bytes"].get("all-reduce", 0)
    assert r["per_pod_wire_bytes"] == per_rank_own * 256
    assert 1.0 < r["per_pod_over_predicted"] < 1.05
    assert r["within_budget"]
    check_outer_sync(r)                        # the honest payload passes
    planted = copy.deepcopy(r)
    planted["per_pod_wire_bytes"] = int(
        2.5 * r["predicted_outer_wire_bytes_per_pod"])
    with pytest.raises(SystemExit, match="budget EXCEEDED"):
        check_outer_sync(planted)


def test_refresh_and_the_paper_roofline_entry(outer, tmp_path):
    from repro_torch.analysis.refresh import refresh
    from repro_torch.paper import roofline
    out, rows = roofline.run(str(tmp_path))
    assert rows == [] and "no dry-run JSONs" in out[0][2]
    cell = {"arch": "suncatcher-lm-100m", "shape": "train_4k",
            "kind": "train", "seq_len": 4096, "global_batch": 256,
            "chips": 256, "mesh": {"data": 16, "model": 16},
            "chip": "h100-sxm", "chip_hbm_capacity_bytes": 80 * 2**30,
            "memory_peak_bytes": 90 * 2**30, "microbatches": 1,
            "flops": {"total": 1.0}, "collectives": {"wire_bytes": 2e9},
            "collectives_loop_aware": {"wire_bytes": 2e9},
            "analytic": {"stale": True}}
    path = tmp_path / "suncatcher-lm-100m_train_4k_single.json"
    path.write_text(json.dumps(cell))
    (tmp_path / "diloco_outer_x_multi.json").write_text(json.dumps(
        {k: v for k, v in outer["int8"].items() if k != "stdout"}))
    assert refresh(str(tmp_path)) == 1
    a = json.loads(path.read_text())["analytic"]
    assert "stale" not in a and a["compute_s"] > 0
    assert a["collective_s_xla_cpu"] == pytest.approx(2e9 / 450e9)
    out, rows = roofline.run(str(tmp_path))
    assert len(rows) == 1 and rows[0]["fits"] is False
    assert out[0][2].startswith("1 dry-run cells; 0 fit the memory of "
                                "h100-sxm")


def _tracked_peak(mt):
    """Peak bytes of a tracker that sees 1 MiB made under the fake mode
    active at its entry and 64 MiB made under a fresh one (what DTensor's
    shape inference at global shapes makes)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        with mt:
            own = torch.ones(256, 1024)             # noqa: F841
            with FakeTensorMode():
                other = torch.ones(4096, 4096)
            del other
    return max(s["Total"] for s in mt.get_tracker_snapshot("peak").values())


def test_rank_mem_tracker_leaves_out_other_fake_modes(monkeypatch):
    """The dry run's MemTracker counts the rank's own 1 MiB whether or not
    torch's MemTracker has its own rule for other fake modes (torch 2.11's
    has none: emulated here by blinding the rule, under which torch's
    tracker counts the 64 MiB too)."""
    import torch.distributed._tools.mem_tracker as mem_tracker

    from repro_torch.launch.dryrun import _rank_mem_tracker
    assert _tracked_peak(_rank_mem_tracker()) == 2**20
    monkeypatch.setattr(mem_tracker, "active_fake_mode", lambda: None,
                        raising=False)
    assert _tracked_peak(mem_tracker.MemTracker()) == 2**20 + 2**26
    assert _tracked_peak(_rank_mem_tracker()) == 2**20


def test_measure_refuses_without_the_shape_inference_hook(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch import dryrun
    monkeypatch.delattr(ShardingPropagator,
                        "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="global-shape inference"):
        dryrun.measure(lambda: None, (), "fake")
