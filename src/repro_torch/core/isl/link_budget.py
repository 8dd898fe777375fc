"""Free-space-optics inter-satellite link budget (paper §2.1 / §4.2, Fig. 1).

Reproduces the paper's analysis exactly:
- Friis far-field received power, 10 cm / 105.1 dB apertures, 5 W EDFA, -3 dB
  other losses; 1.6 uW at a 5,000 km LEO-LEO link.
- Photon-limited data rate for a given photons-per-bit (PPB) requirement:
  OOK ~71 PPB, PM-16QAM ~196 PPB, Shannon-Hartley limit 2 ln 2 ~ 1.39 PPB.
- Near-field symmetric-confocal limit L = pi a^2 / lambda (a = beam radius at
  the optics): ~5 km for a 10 cm aperture.
- COTS DWDM stacking: 24 x 400G on a 100 GHz grid = 9.6 Tbps/aperture
  (-20 dBm/channel -> 0.24 mW for 24 channels); 75 GHz grid -> 12.8 Tbps.
- Spatial multiplexing: an n x n array of D/n sub-apertures fits the same
  total aperture; each sub-link is usable up to its confocal distance, so
  2x2 of 5 cm at <= 1.25 km and 4x4 of 2.5 cm at <= 0.32 km, with aggregate
  bandwidth scaling ~ 1/d.

Pure python/numpy math (no jnp needed — this is design-time analysis).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

H_PLANCK = 6.62607015e-34
C_LIGHT = 299792458.0

# Paper's modulation-scheme photon budgets (photons per bit)
PPB_OOK = 71.0
PPB_PM16QAM = 196.0
PPB_SHANNON = 2.0 * np.log(2.0)          # infinite-bandwidth shot-noise limit

DWDM_CHANNELS_100GHZ = 24                 # half of C-band on 100 GHz grid
DWDM_CHANNELS_75GHZ = 32                  # tighter 75 GHz grid
DWDM_RATE_PER_CHANNEL = 400e9             # 400G coherent transceiver
DWDM_POWER_PER_CHANNEL = 10e-6            # -20 dBm receiver sensitivity


@dataclass(frozen=True)
class OpticalTerminal:
    """One FSO terminal: telescope aperture + EDFA + transceiver bank."""
    aperture_m: float = 0.10              # telescope diameter [m]
    tx_power_w: float = 5.0               # EDFA output [W]
    wavelength_m: float = 1.55e-6
    aperture_efficiency: float = 0.8
    other_losses_db: float = -3.0

    @property
    def antenna_gain(self) -> float:
        """Friis antenna gain ~ eta * (pi D / lambda)^2  (~105.1 dB here)."""
        return self.aperture_efficiency * (
            np.pi * self.aperture_m / self.wavelength_m) ** 2

    @property
    def antenna_gain_db(self) -> float:
        return 10.0 * np.log10(self.antenna_gain)

    @property
    def beam_divergence_rad(self) -> float:
        """Diffraction-limited full divergence ~ 1.22 lambda / D (~18.9 urad)."""
        return 1.22 * self.wavelength_m / self.aperture_m

    @property
    def photon_energy_j(self) -> float:
        return H_PLANCK * C_LIGHT / self.wavelength_m

    def confocal_distance_m(self, aperture_m: float | None = None) -> float:
        """Near-field symmetric confocal link distance L = pi a^2 / lambda."""
        d = self.aperture_m if aperture_m is None else aperture_m
        a = d / 2.0
        return np.pi * a * a / self.wavelength_m

    def received_power_w(self, distance_m, gain=None):
        """Friis far-field received power, clamped to the near-field plateau.

        For d below the confocal distance essentially all transmitted power is
        captured (up to efficiency/other losses), so P_r saturates there.
        `gain` overrides the antenna gain on both ends (the spatial-mux path
        passes the D/n sub-aperture gain); the near-field plateau depends
        only on efficiency, not aperture.
        """
        distance_m = np.asarray(distance_m, dtype=float)
        g = self.antenna_gain if gain is None else gain
        l_other = 10.0 ** (self.other_losses_db / 10.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            pr_far = (self.tx_power_w * g * g * l_other *
                      (self.wavelength_m / (4.0 * np.pi * distance_m)) ** 2)
        pr_near = (self.tx_power_w * self.aperture_efficiency ** 2 * l_other)
        return np.minimum(pr_far, pr_near)

    def beam_spot_radius_m(self, distance_m):
        """Far-field beam spot radius ~ theta * d (the paper's convention,
        with theta = 1.22 lambda/D taken as the half-angle: >=95 m at
        5,000 km)."""
        return self.beam_divergence_rad * np.asarray(distance_m, float)

    def photon_limited_rate_bps(self, distance_m, ppb: float):
        """Max data rate given received power and a photons-per-bit budget."""
        return self.received_power_w(distance_m) / (ppb * self.photon_energy_j)

    def dwdm_rate_bps(self, distance_m, channels: int = DWDM_CHANNELS_100GHZ,
                      rate_per_channel: float = DWDM_RATE_PER_CHANNEL,
                      power_per_channel: float = DWDM_POWER_PER_CHANNEL):
        """DWDM stack throughput: power-feasible channels x 400G, capped."""
        pr = self.received_power_w(distance_m)
        feasible = np.floor(pr / power_per_channel)
        return np.minimum(feasible, channels) * rate_per_channel

    def max_dwdm_distance_m(self, channels: int = DWDM_CHANNELS_100GHZ,
                            margin_db: float = 3.0) -> float:
        """Largest distance at which the full DWDM stack closes with a
        `margin_db` link margin (~300 km for 24 channels at 3 dB)."""
        need = channels * DWDM_POWER_PER_CHANNEL * 10.0 ** (margin_db / 10.0)
        g = self.antenna_gain
        l_other = 10.0 ** (self.other_losses_db / 10.0)
        # invert Friis
        return (self.wavelength_m / (4.0 * np.pi)) * np.sqrt(
            self.tx_power_w * g * g * l_other / need)

    def spatial_mux_count(self, distance_m) -> np.ndarray:
        """Largest n s.t. an n x n array of D/n sub-apertures still resolves
        independent beams at this distance (sub-link confocal limit)."""
        distance_m = np.asarray(distance_m, dtype=float)
        n = np.floor((self.aperture_m / 2.0) *
                     np.sqrt(np.pi / (self.wavelength_m * distance_m)))
        return np.maximum(n, 1.0)

    def aggregate_bandwidth_bps(self, distance_m,
                                channels: int = DWDM_CHANNELS_100GHZ,
                                rate_per_channel: float = DWDM_RATE_PER_CHANNEL,
                                power_per_channel: float = DWDM_POWER_PER_CHANNEL):
        """Aggregate per-link bandwidth with spatial multiplexing (Fig. 1):
        n(d)^2 parallel DWDM streams through D/n sub-apertures.

        Fully vectorized: the n x n array of D/n sub-apertures is inlined as
        a gain rescale (each sub-link carries its own EDFA power budget, per
        the per-terminal transceiver bank), so an (N, N) bandwidth matrix
        costs one array expression instead of N^2 terminal constructions.
        """
        distance_m = np.asarray(distance_m, dtype=float)
        n = self.spatial_mux_count(distance_m)
        # sub-aperture gain eta * (pi (D/n) / lambda)^2 through the one
        # shared link-budget formula
        g = self.aperture_efficiency * (
            np.pi * self.aperture_m / (n * self.wavelength_m)) ** 2
        pr = self.received_power_w(distance_m, gain=g)
        feasible = np.floor(pr / power_per_channel)
        out = n * n * np.minimum(feasible, channels) * rate_per_channel
        return float(out) if np.ndim(distance_m) == 0 else out


def required_pointing_accuracy_rad(aperture_m: float = 0.10,
                                   distance_m: float = 5e3,
                                   wander_frac: float = 0.1) -> float:
    """Pointing accuracy to limit beam wander to `wander_frac` of the
    aperture radius at the confocal design point (~1.0 urad in the paper)."""
    return wander_frac * (aperture_m / 2.0) / distance_m
