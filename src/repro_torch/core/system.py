"""SpaceCluster: the paper's system design as one deployable object.

Composes the four quantitative models (orbital formation, ISL link budget,
radiation environment, launch economics) with an accelerator spec into
the summary the paper reports: chips, peak rate, pod-axis bandwidth, SDC
rate, Young-Daly checkpoint interval and launch cost.

Two accelerator specs live here and are not to be confused:

- `ChipSpec()` is the paper's modelled satellite chip (a TPU v5e-class
  part): a design input of `SpaceCluster`, kept at the reference's
  figures so that the summary is the paper's.  It is not the card the
  port runs on.
- `H100_SXM` is that card, at its data-sheet figures: what the port's
  roofline (`repro_torch.analysis`) and `chip_smoke.py`'s kernel bounds
  are priced at.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .economics import SatelliteBus
from .isl import ISLNetwork, pod_axis_bandwidth_bytes
from .orbital.cluster import ClusterDesign
from .radiation import RadiationEnvironment


@dataclass(frozen=True)
class ChipSpec:
    """An accelerator's roofline constants.  The defaults are the paper's
    modelled satellite chip (TPU v5e-class), not a measured part."""
    name: str = "tpu-v5e-like"
    peak_bf16_flops: float = 197e12         # FLOP/s
    hbm_bytes_per_s: float = 819e9          # HBM bandwidth
    ici_bytes_per_s: float = 50e9           # chip-to-chip link rate
    hbm_capacity_bytes: float = 16 * 2**30
    power_w: float = 250.0


# NVIDIA H100 SXM5, from NVIDIA's H100 data sheet (SXM column; dense
# rates, without sparsity; at the full 700 W power limit)
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_bf16_flops=989e12,     # bf16 tensor-core rate, dense
    hbm_bytes_per_s=3.35e12,    # HBM3 bandwidth
    # NVLink 4: 900 GB/s over 18 links counts both directions; a device
    # sends at half of it, and the roofline divides bytes sent by this
    ici_bytes_per_s=450e9,
    hbm_capacity_bytes=80 * 2**30,  # 80 GiB HBM3
    power_w=700.0,              # max thermal design power (SXM)
)


@dataclass(frozen=True)
class SatelliteSpec:
    """One satellite = one pod slice: chips + bus + FSO terminals."""
    chips: int = 256                        # 16 x 16 intra-satellite mesh
    chip: ChipSpec = field(default_factory=ChipSpec)
    bus_mass_kg: float = 1200.0             # solar + radiators + structure
    payload_mass_kg: float = 800.0          # compute + thermal + terminals
    lifespan_years: float = 5.0             # radiation-limited (§2.3)
    solar_power_kw: float = 84.0            # ~3x Starlink v2 array

    @property
    def mass_kg(self) -> float:
        return self.bus_mass_kg + self.payload_mass_kg

    @property
    def compute_power_kw(self) -> float:
        return self.chips * self.chip.power_w / 1e3

    def as_bus(self) -> SatelliteBus:
        return SatelliteBus("ml-satellite", self.mass_kg,
                            self.solar_power_kw, self.lifespan_years)


@dataclass(frozen=True)
class SpaceCluster:
    """An N-satellite ML datacenter in dawn-dusk sun-synchronous LEO."""
    n_satellites: int = 81
    satellite: SatelliteSpec = field(default_factory=SatelliteSpec)
    formation: ClusterDesign = field(default_factory=ClusterDesign)
    isl: ISLNetwork = field(default_factory=ISLNetwork)
    radiation: RadiationEnvironment = field(
        default_factory=RadiationEnvironment)

    # --- compute ------------------------------------------------------------
    @property
    def total_chips(self) -> int:
        return self.n_satellites * self.satellite.chips

    @property
    def peak_flops(self) -> float:
        return self.total_chips * self.satellite.chip.peak_bf16_flops

    # --- network -------------------------------------------------------------
    def pod_axis_bandwidth_bytes(self, conservative: bool = True) -> float:
        """Satellite-to-satellite (pod-axis) bandwidth from the link budget
        at formation distances (§2.1): >=9.6 Tbps/aperture, x16 spatial mux
        at the ~100-200 m neighbor distances if not conservative."""
        return pod_axis_bandwidth_bytes(conservative=conservative)

    def ici_bandwidth_bytes(self) -> float:
        return self.satellite.chip.ici_bytes_per_s

    # --- reliability ----------------------------------------------------------
    def expected_sdc_per_step(self, step_time_s: float) -> float:
        return self.radiation.expected_events(self.total_chips, step_time_s)

    def checkpoint_interval_s(self, checkpoint_cost_s: float = 30.0) -> float:
        return self.radiation.optimal_checkpoint_interval_s(
            self.total_chips, checkpoint_cost_s)

    # --- economics -------------------------------------------------------------
    def launch_cost_usd(self, usd_per_kg: float = 200.0) -> float:
        return self.n_satellites * self.satellite.mass_kg * usd_per_kg

    def launched_power_price(self, usd_per_kg: float = 200.0) -> float:
        return self.satellite.as_bus().launched_power_price(usd_per_kg)

    def summary(self) -> dict:
        return {
            "satellites": self.n_satellites,
            "chips": self.total_chips,
            "peak_bf16_pflops": self.peak_flops / 1e15,
            "pod_axis_GBps": self.pod_axis_bandwidth_bytes() / 1e9,
            "ici_GBps": self.ici_bandwidth_bytes() / 1e9,
            "sdc_events_per_chip_year":
                self.radiation.sdc_events_per_chip_year(),
            "checkpoint_interval_s": self.checkpoint_interval_s(),
            "launch_cost_musd_at_200":
                self.launch_cost_usd(200.0) / 1e6,
            "launched_power_usd_per_kw_year":
                self.launched_power_price(200.0),
        }
