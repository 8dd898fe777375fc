"""TPU radiation-effects model, calibrated to the paper's beam test (§2.3/§4.3).

The paper irradiated a Trillium (v6e) TPU + AMD host with 67 MeV protons at
UC Davis CNL and reports characteristic doses per event; with the standard
fluence conversion (1 rad ~ 7.9e6 p/cm^2) these give per-chip cross-sections
sigma ~ 1.27e-7 / D cm^2, where D is dose-per-event in rad:

  - SDC (core logic + SRAM, end-to-end ML workloads): D ~ 14.4-20 rad/event
    (sigma ~ 6-9e-9 cm^2) -> at 150 rad(Si)/yr in shielded sun-sync LEO,
    ~1 silent corruption per ~3M inferences at 1 inference/s.
  - HBM UECC: D ~ 44 rad/event (sigma ~ 3e-9 cm^2).
  - Chip SEFI (crash/reboot): D ~ 5 krad/event (sigma ~ 2e-11 cm^2).
  - Host CPU SEFI: 1/450 rad; host RAM SEFI: 1/400 rad.
  - TID: HBM irregularities from 2 krad (2.7x the 750 rad 5-year mission
    requirement); all else clean to >= 15 krad.

This model feeds the fault-tolerant training loop: expected event counts per
step give the bit-flip injection schedule and the checkpoint-interval
optimizer.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SECONDS_PER_YEAR = 365.2421897 * 86400.0

# Paper's measured constants
DOSE_RATE_RAD_PER_YEAR = 150.0        # shielded sun-sync LEO estimate
MISSION_YEARS = 5.0
MISSION_TID_RAD = DOSE_RATE_RAD_PER_YEAR * MISSION_YEARS      # 750 rad
HBM_TID_IRREGULARITY_RAD = 2000.0     # first HBM stress irregularities
MAX_TESTED_TID_RAD = 15000.0          # no hard failure up to here
FLUENCE_PER_RAD = 7.9e6               # protons / cm^2 / rad
SIGMA_NUMERATOR = 1.27e-7             # sigma = SIGMA_NUMERATOR / D  [cm^2/chip]

SDC_DOSE_PER_EVENT_RAD = 17.0         # typical transformer workload (14.4-20)
SDC_DOSE_RANGE_RAD = (14.4, 20.0)
HBM_UECC_DOSE_PER_EVENT_RAD = 44.0
SEFI_DOSE_PER_EVENT_RAD = 5000.0
HOST_CPU_SEFI_DOSE_RAD = 450.0
HOST_RAM_SEFI_DOSE_RAD = 400.0


def cross_section_cm2(dose_per_event_rad: float) -> float:
    """Per-chip SEE cross-section from a characteristic dose-per-event."""
    return SIGMA_NUMERATOR / dose_per_event_rad


def events_per_year(dose_per_event_rad: float,
                    dose_rate: float = DOSE_RATE_RAD_PER_YEAR) -> float:
    return dose_rate / dose_per_event_rad


@dataclass(frozen=True)
class RadiationEnvironment:
    """Orbital radiation environment + per-chip event-rate calculator."""
    dose_rate_rad_per_year: float = DOSE_RATE_RAD_PER_YEAR

    def rate_per_chip_second(self, dose_per_event_rad: float) -> float:
        return (self.dose_rate_rad_per_year / dose_per_event_rad /
                SECONDS_PER_YEAR)

    # --- headline paper numbers -------------------------------------------
    def sdc_events_per_chip_year(self) -> float:
        return events_per_year(SDC_DOSE_PER_EVENT_RAD,
                               self.dose_rate_rad_per_year)

    def inferences_per_sdc(self, inferences_per_second: float = 1.0) -> float:
        """~3e6 at 1 inference/s (the paper's '1 per 3 million inferences')."""
        rate = self.rate_per_chip_second(SDC_DOSE_PER_EVENT_RAD)
        return inferences_per_second / rate

    def sefi_events_per_chip_year(self) -> float:
        return events_per_year(SEFI_DOSE_PER_EVENT_RAD,
                               self.dose_rate_rad_per_year)

    def tid_margin(self) -> float:
        """HBM TID irregularity threshold over the 5-year mission dose (~2.7x)."""
        return HBM_TID_IRREGULARITY_RAD / MISSION_TID_RAD

    # --- training-system quantities ---------------------------------------
    def expected_events(self, n_chips: int, seconds: float,
                        dose_per_event_rad: float = SDC_DOSE_PER_EVENT_RAD
                        ) -> float:
        return n_chips * seconds * self.rate_per_chip_second(dose_per_event_rad)

    def sample_event_count(self, rng: np.random.Generator, n_chips: int,
                           seconds: float,
                           dose_per_event_rad: float = SDC_DOSE_PER_EVENT_RAD
                           ) -> int:
        return int(rng.poisson(self.expected_events(
            n_chips, seconds, dose_per_event_rad)))

    def optimal_checkpoint_interval_s(self, n_chips: int,
                                      checkpoint_cost_s: float) -> float:
        """Young/Daly optimum: T* = sqrt(2 * C / lambda) for restart-class
        failures (SEFI + HBM UECC), which is what forces a rollback."""
        lam = n_chips * (
            self.rate_per_chip_second(SEFI_DOSE_PER_EVENT_RAD)
            + self.rate_per_chip_second(HBM_UECC_DOSE_PER_EVENT_RAD))
        return float(np.sqrt(2.0 * checkpoint_cost_s / lam))
