"""Radiation effects (TID/SEE) model and SDC fault injection (paper §2.3)."""
from .injection import (SDCInjector, count_changed_elements, flip_bits,
                        inject_tree)
from .seu import (DOSE_RATE_RAD_PER_YEAR, HBM_TID_IRREGULARITY_RAD,
                  HBM_UECC_DOSE_PER_EVENT_RAD, MISSION_TID_RAD,
                  SDC_DOSE_PER_EVENT_RAD, SEFI_DOSE_PER_EVENT_RAD,
                  RadiationEnvironment, cross_section_cm2, events_per_year)

__all__ = [
    "SDCInjector", "count_changed_elements", "flip_bits", "inject_tree",
    "RadiationEnvironment",
    "cross_section_cm2", "events_per_year", "DOSE_RATE_RAD_PER_YEAR",
    "MISSION_TID_RAD", "HBM_TID_IRREGULARITY_RAD", "SDC_DOSE_PER_EVENT_RAD",
    "HBM_UECC_DOSE_PER_EVENT_RAD", "SEFI_DOSE_PER_EVENT_RAD",
]
