"""Radiation effects model (paper §2.3): measured event rates per chip.
The SDC injector (`injection.py`) is not ported (ROADMAP A6)."""
from .seu import (DOSE_RATE_RAD_PER_YEAR, HBM_TID_IRREGULARITY_RAD,
                  HBM_UECC_DOSE_PER_EVENT_RAD, MISSION_TID_RAD,
                  SDC_DOSE_PER_EVENT_RAD, SEFI_DOSE_PER_EVENT_RAD,
                  RadiationEnvironment, cross_section_cm2, events_per_year)

__all__ = [
    "RadiationEnvironment",
    "cross_section_cm2", "events_per_year", "DOSE_RATE_RAD_PER_YEAR",
    "MISSION_TID_RAD", "HBM_TID_IRREGULARITY_RAD", "SDC_DOSE_PER_EVENT_RAD",
    "HBM_UECC_DOSE_PER_EVENT_RAD", "SEFI_DOSE_PER_EVENT_RAD",
]
