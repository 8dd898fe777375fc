"""§2.3/§4.3 radiation results: cross-sections, SDC/SEFI rates, TID margin.
Host numpy."""
import time

from repro_torch.core.radiation import (HBM_UECC_DOSE_PER_EVENT_RAD,
                                        SDC_DOSE_PER_EVENT_RAD,
                                        SEFI_DOSE_PER_EVENT_RAD,
                                        RadiationEnvironment,
                                        cross_section_cm2)


def run():
    t0 = time.time()
    env = RadiationEnvironment()
    rows = {
        "sdc_sigma_cm2": cross_section_cm2(SDC_DOSE_PER_EVENT_RAD),
        "hbm_uecc_sigma_cm2": cross_section_cm2(HBM_UECC_DOSE_PER_EVENT_RAD),
        "sefi_sigma_cm2": cross_section_cm2(SEFI_DOSE_PER_EVENT_RAD),
        "sdc_per_chip_year": env.sdc_events_per_chip_year(),
        "inferences_per_sdc": env.inferences_per_sdc(1.0),
        "tid_margin": env.tid_margin(),
        "ckpt_interval_s_81x256": env.optimal_checkpoint_interval_s(
            81 * 256, 30.0),
    }
    us = (time.time() - t0) * 1e6
    derived = (f"1 SDC per {rows['inferences_per_sdc']/1e6:.1f}M inferences;"
               f" {rows['sdc_per_chip_year']:.1f} SDC/chip/yr;"
               f" TID margin {rows['tid_margin']:.1f}x;"
               f" Young-Daly ckpt {rows['ckpt_interval_s_81x256']:.0f}s"
               f" @81 sats")
    return [("radiation_table", us, derived)], rows
