"""Figure 1: OISL bandwidth vs distance for OOK / PM-16QAM / Shannon,
DWDM + spatial-multiplexing design points, vs commercial long-range OISLs.
Host numpy."""
import time

import numpy as np

from repro_torch.core.isl import (PPB_OOK, PPB_PM16QAM, PPB_SHANNON,
                                  OpticalTerminal)


def run():
    t0 = time.time()
    term = OpticalTerminal()
    rows = []
    dists = np.array([0.1, 0.32, 1.25, 5, 50, 300, 1000, 5400]) * 1e3
    for d in dists:
        rows.append({
            "distance_km": d / 1e3,
            "P_r_W": float(term.received_power_w(d)),
            "bw_shannon_Tbps": float(term.photon_limited_rate_bps(
                d, PPB_SHANNON)) / 1e12,
            "bw_ook_Tbps": float(term.photon_limited_rate_bps(
                d, PPB_OOK)) / 1e12,
            "bw_16qam_Tbps": float(term.photon_limited_rate_bps(
                d, PPB_PM16QAM)) / 1e12,
            "dwdm_Tbps": float(term.dwdm_rate_bps(d)) / 1e12,
            "agg_spatial_mux_Tbps": float(
                term.aggregate_bandwidth_bps(d)) / 1e12,
        })
    us = (time.time() - t0) * 1e6 / len(dists)
    derived = (f"24ch-DWDM=9.6Tbps to {term.max_dwdm_distance_m()/1e3:.0f}km;"
               f" 2x2@{term.confocal_distance_m(0.05)/1e3:.2f}km;"
               f" 4x4@{term.confocal_distance_m(0.025)/1e3:.2f}km;"
               f" Pr(5000km)={term.received_power_w(5e6)*1e6:.1f}uW")
    return [("fig1_isl_bandwidth", us, derived)], rows
