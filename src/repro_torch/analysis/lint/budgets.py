"""Layer 2: budget checks measured by running each device entry point
once, eagerly, on a reduced config (BG001/BG002/BG003).

The counterpart of the reference's lower-never-execute budgets
(`repro.analysis.lint.budgets`): eager PyTorch has no compiled graph to
read, so each ``BUDGETS`` entry runs its device function once under the
counters of `repro_torch.analysis.collectives`:

* BG001 — host syncs (`HostSyncCounter`, the reference's host-callback
  schema: `count`, `targets`), 0 for every entry; on the card
  `torch.cuda.set_sync_debug_mode("warn")` is a second witness, also 0.
  An entry that fails to run is a BG001 finding too, never a skip.
* BG002 — pod-axis collective bytes.  The outer sync runs as rank 0 of a
  fake (2, 2, 2) process group (`launch/dryrun.py`'s outer-sync cell on
  the reduced config) and its per-pod payload must stay within
  ``LINT_BUDGET["outer_wire_budget_factor"]`` x the `outer_wire_bytes`
  prediction for its own compress mode; the hidden
  ``diloco-outer-sync-regression`` entry runs the simulated int8 hop,
  which gathers the f32 deltas whole, and must FAIL.  The engine's
  decode block moves 0 collective bytes.
* BG003 — compiled variants: the engine's decode block and prefill
  buckets run with at most ``LINT_BUDGET["max_traces"]`` input
  signatures (`ServingEngine.trace_count`), len(buckets) + 1.

This module imports torch; the AST layer never imports it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .findings import Finding

_SELF = "src/repro_torch/analysis/lint/budgets.py"

# the host reads `run_budget_checks(plant=...)` can put inside the
# engine's decode block: a test of the counters, never of the engine
PLANTS = ("item", "cpu", "tolist", "if", "nonzero")


def _planted_read(kind: str, t):
    import torch
    if kind == "item":
        t[0, 0].item()
    elif kind == "cpu":
        t.cpu()
    elif kind == "tolist":
        t[0].tolist()
    elif kind == "if":
        if t[0, 0] > 0:
            pass
    elif kind == "nonzero":
        torch.nonzero(t > 0)


@dataclass
class BudgetSpec:
    name: str
    runner: Callable[["BudgetSpec", "_Run"], list[Finding]]
    max_host_syncs: int = 0
    wire_budget_factor: float | None = None
    max_traces: int | None = None
    hidden: bool = False  # regression demos: only run via --only
    params: dict = field(default_factory=dict)


@dataclass
class _Run:
    """One entry's run: where it runs, an optional planted fault, and
    what it measured (the CLI's report line)."""

    device: str
    plant: str | None = None
    report: dict = field(default_factory=dict)

    def syncs(self, spec: BudgetSpec, what: str, fn, *args):
        """fn(*args) once under the host-sync counts; BG001 findings for
        any count above the entry's budget.  Returns (out, findings)."""
        import torch

        from repro_torch.analysis.collectives import (HostSyncCounter,
                                                      sync_debug_warnings)
        counter = HostSyncCounter(self.device)
        with sync_debug_warnings() as warned, counter:
            out = fn(*args)
        if self.device == "cuda":
            torch.cuda.synchronize()
        n = counter.host_syncs()
        n_warn = len(warned)
        self.report["host_syncs"] = self.report.get("host_syncs", 0) + n["count"]
        if self.device == "cuda":
            self.report["sync_debug_warnings"] = \
                self.report.get("sync_debug_warnings", 0) + n_warn
        findings = []
        if n["count"] > spec.max_host_syncs:
            findings.append(Finding(
                "BG001", _SELF, 0, spec.name,
                f"{what}: {n['count']} host sync(s) (budget "
                f"{spec.max_host_syncs}): {n['targets']}",
                hint="a device entry point reads nothing on the host; "
                     "drain at the host boundary"))
        if n_warn > spec.max_host_syncs:
            findings.append(Finding(
                "BG001", _SELF, 0, spec.name,
                f"{what}: {n_warn} synchronizing operation(s) under sync "
                f"debug mode (budget {spec.max_host_syncs})",
                hint="a device entry point reads nothing on the host; "
                     "drain at the host boundary"))
        return out, findings


# -- diloco outer sync (the pod-axis FSO hop) -------------------------


def _run_outer_sync(spec: BudgetSpec, run: _Run) -> list[Finding]:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy
    from repro_torch.train.diloco import LINT_BUDGET

    spec.max_host_syncs = LINT_BUDGET["host_callbacks"]
    spec.wire_budget_factor = LINT_BUDGET["outer_wire_budget_factor"]
    compress = spec.params.get("compress", "none")
    try:
        r = dryrun.run_outer_sync_cell(
            arch=spec.params.get("arch", "suncatcher-lm-100m"),
            compress=compress, simulated=spec.params.get("simulated", False),
            out_dir=None, verbose=False, reduced=True, mesh_shape=(2, 2, 2),
            device="cuda" if run.device == "cuda" else "fake")
    finally:
        destroy()
    predicted = r["predicted_outer_wire_bytes_per_pod"]
    per_pod = r["per_pod_wire_bytes"]
    cap = spec.wire_budget_factor * predicted
    warned = r.get("sync_debug_warnings", 0)
    run.report.update(host_syncs=r["host_syncs"]["count"],
                      per_pod_wire_bytes=per_pod, predicted=predicted,
                      ratio=r["per_pod_over_predicted"])
    if run.device == "cuda":
        run.report["sync_debug_warnings"] = warned
    findings = []
    if max(r["host_syncs"]["count"], warned) > spec.max_host_syncs:
        findings.append(Finding(
            "BG001", _SELF, 0, spec.name,
            f"outer_step: {r['host_syncs']['count']} host sync(s) "
            f"({r['host_syncs']['targets']}), {warned} under sync debug "
            f"mode (budget {spec.max_host_syncs})",
            hint="the outer sync reads nothing on the host"))
    if per_pod > cap:
        by_dtype = {k: {d: round(b / 2**20, 3) for d, b in v.items()}
                    for k, v in r["collectives"]["bytes_by_dtype"].items()}
        findings.append(Finding(
            "BG002", _SELF, 0, spec.name,
            f"outer sync (compress={compress}) moves {per_pod / 2**20:.3f} "
            f"MiB per pod, budget {cap / 2**20:.3f} MiB "
            f"({spec.wire_budget_factor}x the {predicted / 2**20:.3f} MiB "
            f"predicted payload); per rank by op and dtype (MiB): {by_dtype}",
            hint="the compressed payload must be what crosses the pod axis: "
                 "the wire hop (_wire_shard_hop), not the f32 deltas "
                 "gathered whole"))
    return findings


# -- diloco fused round ------------------------------------------------


def _micro_model(arch: str, device, overrides=None):
    """A reduced config (the reference's budget dims for a transformer),
    its functions and params drawn from seed 0 on `device`."""
    import torch

    from repro_torch.models import registry
    if overrides is None:
        overrides = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                         d_ff=64, vocab_size=256)
    cfg = registry.get_reduced_config(arch, **overrides)
    fns = registry.model_fns(cfg)
    return cfg, fns, fns.init(torch.Generator().manual_seed(0), cfg, device)


def _run_diloco_round(spec: BudgetSpec, run: _Run) -> list[Finding]:
    import torch

    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.diloco import (LINT_BUDGET, DiLoCoConfig,
                                          diloco_init, make_diloco_round)
    from repro_torch.train.loop import TrainConfig

    spec.max_host_syncs = LINT_BUDGET["host_callbacks"]
    cfg, fns, params = _micro_model(
        spec.params.get("arch", "suncatcher-lm-100m"), run.device)
    dcfg = DiLoCoConfig(n_pods=2, inner_steps=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                  global_batch=2), run.device)
    # the on-device data path (step-id batches): no host data movement,
    # so the budget covers batch generation too
    round_fn = make_diloco_round(cfg, fns, TrainConfig(), dcfg, data=data)
    d_state = diloco_init(params, dcfg)
    steps = torch.arange(4, dtype=torch.int32,
                         device=run.device).reshape(2, 2)
    mask = torch.ones(2, device=run.device)
    thr = torch.tensor([3.0, 10.0], device=run.device)
    _, findings = run.syncs(spec, "diloco round", round_fn, d_state, steps,
                            mask, thr)
    return findings


# -- serving engine: decode block, prefill buckets, migration ----------


def _run_engine(spec: BudgetSpec, run: _Run) -> list[Finding]:
    import numpy as np
    import torch

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.serving.engine import (LINT_BUDGET, EngineConfig,
                                            Request, ServingEngine)
    from repro_torch.serving.router import LINT_BUDGET as ROUTER_BUDGET

    spec.max_host_syncs = LINT_BUDGET["host_callbacks"]
    spec.max_traces = LINT_BUDGET["max_traces"]
    cfg, fns, params = _micro_model(
        spec.params.get("arch", "suncatcher-lm-100m"), run.device,
        spec.params.get("overrides"))
    ecfg = EngineConfig(max_batch=2, max_len=64, **spec.params.get("engine", {}))
    eng = ServingEngine(cfg, fns, params, ecfg)
    if run.plant is not None:
        sample = eng._sample

        def planted(logits, keys, temps):
            _planted_read(run.plant, logits)
            return sample(logits, keys, temps)
        eng._sample = planted

    # one request in flight, admitted through the engine's own path (its
    # drain is the host boundary, not measured), so the decode block
    # decodes a live row
    eng.submit(Request(uid=0, prompt=np.arange(1, 11, dtype=np.int32),
                       max_new_tokens=8, temperature=0.7))
    eng._fill_slots()

    findings: list[Finding] = []
    coll = CollectiveCounter()
    with coll:
        out, f = run.syncs(spec, "engine decode block", eng._engine_step_impl,
                           eng.params, eng.cache, eng.state)
    findings += f
    eng.cache, eng.state = out[0], out[1]
    wire = coll.collective_bytes()["wire_bytes"]
    run.report["decode_wire_bytes"] = wire
    if wire > LINT_BUDGET["decode_collective_wire_bytes"]:
        findings.append(Finding(
            "BG002", _SELF, 0, spec.name,
            f"decode block emits {wire} collective wire bytes; the "
            "single-pod decode path budget is 0",
            hint="decode must stay pod-local; collectives belong to the outer sync"))

    b, dev = ecfg.max_batch, eng.device
    i32 = lambda v=0: torch.full((b,), v, dtype=torch.int32, device=dev)  # noqa: E731
    no = torch.zeros((b,), dtype=torch.bool, device=dev)
    for lb in eng.buckets():
        page_ops = {"pf_entry": i32(-1), "pf_n": i32(), "pf_store": i32(-1),
                    "pf_store_n": i32()}
        out, f = run.syncs(
            spec, f"prefill bucket {lb}", eng._prefill_impl, eng.params,
            eng.cache, eng.state, torch.zeros((b, lb), dtype=torch.int32,
                                              device=dev),
            i32(), no, torch.zeros((b,), device=dev), i32(-1), i32(1), i32(),
            page_ops)
        findings += f
        eng.cache, eng.state = out[0], out[1]

    # the router's failover and replication drive these; its budget is
    # zero host syncs too
    spec.max_host_syncs = ROUTER_BUDGET["host_callbacks"]
    idx = i32()
    out, f = run.syncs(spec, "slot export (migration)", eng._export_impl,
                       eng.cache, eng.state, idx, no)
    findings += f
    bcache, bstate = out[0], out[1]
    _, f = run.syncs(spec, "slot import (migration)", eng._import_impl,
                     eng.cache, eng.state, bcache, bstate, idx, no)
    findings += f
    out, f = run.syncs(spec, "delta export (replication)",
                       eng._delta_export_impl, eng.cache, eng.state, idx,
                       i32(), ecfg.max_len)
    findings += f
    eng.ensure_standby()
    _, f = run.syncs(spec, "standby apply (replication)",
                     eng._standby_apply_impl, eng.standby["cache"],
                     eng.standby["state"], out[0], out[1], idx, i32(), no)
    findings += f
    _, f = run.syncs(spec, "deactivate", eng._deactivate_impl, eng.cache,
                     eng.state, no)
    findings += f

    traces = eng.trace_count("_engine_step_impl", "_prefill_impl")
    run.report["traces"] = traces
    if spec.max_traces is not None and traces > spec.max_traces:
        findings.append(Finding(
            "BG003", _SELF, 0, spec.name,
            f"{traces} compiled variants for decode+prefill, budget "
            f"{spec.max_traces} (buckets: {eng.buckets()})",
            hint="pow2 bucketing must bound variants at len(buckets)+1"))
    return findings


# -- publish snapshot --------------------------------------------------


def _run_publish(spec: BudgetSpec, run: _Run) -> list[Finding]:
    from repro_torch.train.diloco import (DiLoCoConfig, diloco_init,
                                          snapshot_global_params)
    from repro_torch.train.publish import LINT_BUDGET

    spec.max_host_syncs = LINT_BUDGET["host_callbacks"]
    _, _, params = _micro_model(spec.params.get("arch", "suncatcher-lm-100m"),
                                run.device)
    d_state = diloco_init(params, DiLoCoConfig(n_pods=2))
    _, findings = run.syncs(spec, "publish snapshot", snapshot_global_params,
                            d_state)
    return findings


BUDGETS: dict[str, BudgetSpec] = {
    s.name: s
    for s in [
        BudgetSpec(name="diloco-outer-sync", runner=_run_outer_sync,
                   params={"compress": "none"}),
        # the wire hop: the s8 payload + f32 scales (top-k: f32 values +
        # s32 indices) are what the pod-axis all-gathers carry
        BudgetSpec(name="diloco-outer-sync-int8", runner=_run_outer_sync,
                   params={"compress": "int8"}),
        BudgetSpec(name="diloco-outer-sync-topk", runner=_run_outer_sync,
                   params={"compress": "topk"}),
        # the simulated int8 hop on a mesh gathers the f32 deltas whole
        # before compressing: "int8" in name only; must FAIL
        BudgetSpec(name="diloco-outer-sync-regression",
                   runner=_run_outer_sync, hidden=True,
                   params={"compress": "int8", "simulated": True}),
        BudgetSpec(name="diloco-round", runner=_run_diloco_round),
        BudgetSpec(name="engine-serve", runner=_run_engine),
        # the paged KV layout through the same entry points: the device
        # page allocator never reads the host
        BudgetSpec(name="engine-serve-paged", runner=_run_engine,
                   params={"engine": {"page_size": 16, "prefix_cache": 4}}),
        # a carry family through the same serving and replication entry
        # points: the reduced recurrentgemma config as it is
        BudgetSpec(name="engine-serve-rglru", runner=_run_engine,
                   params={"arch": "recurrentgemma-2b", "overrides": {}}),
        BudgetSpec(name="publish-snapshot", runner=_run_publish),
    ]
}


def run_budget_checks(only: list[str] | None = None, device: str = "cpu",
                      plant: str | None = None
                      ) -> tuple[list[Finding], dict[str, dict]]:
    """Run the visible entries (or exactly `only`, hidden ones included)
    on `device`.  Returns (findings, {entry: its measurements}).
    `plant` puts one of `PLANTS` inside the engine's decode block."""
    import time

    unknown = set(only or ()) - set(BUDGETS)
    if unknown:
        raise SystemExit(f"unknown budget entries {sorted(unknown)}; "
                         f"known: {sorted(BUDGETS)}")
    findings: list[Finding] = []
    reports: dict[str, dict] = {}
    for name, spec in BUDGETS.items():
        if only is not None:
            if name not in only:
                continue
        elif spec.hidden:
            continue
        run = _Run(device, plant)
        t0 = time.perf_counter()
        try:
            found = spec.runner(spec, run)
        except Exception as e:  # an entry that fails to run is a finding
            found = [Finding(
                "BG001", _SELF, 0, name,
                f"budget entry failed to run: {type(e).__name__}: {e}",
                hint="the entry's build recipe drifted from the module under budget")]
        findings += found
        reports[name] = {**run.report, "seconds": round(time.perf_counter() - t0, 2),
                         "ok": not found}
    return findings, reports
