"""Three-term roofline of a step, priced for one accelerator.

    compute    = FLOPs_per_device / peak_FLOPs_per_chip
    memory     = bytes_per_device / HBM_bw_per_chip
    collective = wire_bytes_per_device / link_bw

The per-device FLOPs and bytes come from a cost model (the reference reads
them from a compiled dry run's `cost_analysis()`; the port's dry run
counts them on a fake process group, `launch/dryrun.py`) or from
`analytic.py`.  The collective term uses the
chip's link rate for the intra-pod axes; the `pod` hop instead has the
FSO ISL budget of `repro_torch.core.isl` (1.2 TB/s per satellite at the
formation distances).

`model_flops` is the useful work, `analytic.useful_flops` (6*N*D train,
2*N*D forward-only, N = active params); the ratio model_flops /
(FLOPs * chips) exposes remat and dispatch waste.

`RooflineTerms` carries the chip it was priced for, and its `mfu` divides
by that chip's peak.  The reference's divides by the default
`ChipSpec()`'s whatever chip `roofline` was given (ROADMAP C11), so the
two agree only at the default chip.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.system import ChipSpec


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float
    chips: int
    chip: ChipSpec = ChipSpec()

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The roofline bound: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def utility_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-bound step time, against
        the peak of the chip these terms were priced for."""
        if self.step_time_s == 0:
            return 0.0
        peak = self.chip.peak_bf16_flops * self.chips
        return self.model_flops / (self.step_time_s * peak)


def roofline(cost_analysis: dict, wire_bytes: float, *, chips: int,
             model_flops: float, chip: ChipSpec = ChipSpec(),
             pod_axis_bytes: float = 0.0,
             isl_bytes_per_s: float = 1.2e12) -> RooflineTerms:
    flops = float(cost_analysis.get("flops", 0.0))
    bytes_ = float(cost_analysis.get("bytes accessed", 0.0))
    coll = wire_bytes / chip.ici_bytes_per_s
    if pod_axis_bytes:
        coll += pod_axis_bytes / isl_bytes_per_s
    return RooflineTerms(
        compute_s=flops / chip.peak_bf16_flops,
        memory_s=bytes_ / chip.hbm_bytes_per_s,
        collective_s=coll,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        wire_bytes_per_device=wire_bytes,
        model_flops=model_flops,
        chips=chips,
        chip=chip,
    )

