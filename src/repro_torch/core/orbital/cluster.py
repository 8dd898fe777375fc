"""The paper's illustrative 81-satellite, 1 km-radius planar cluster (§2.2):
a 9x9 square lattice in the HCW (alpha, beta) plane with 100 m spacing,
in the plane of a circular, dawn-dusk sun-synchronous reference orbit at
650 km.  The J2 numerical orbit (`simulate_cluster`, `initial_states`,
`reference_state`) is not ported (ROADMAP A6)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import constants as C
from .hcw import lattice_alpha_beta


def mean_motion(a: float, mu: float = C.MU_EARTH) -> float:
    return (mu / a**3) ** 0.5


def sun_sync_inclination(a: float) -> float:
    """Inclination [rad] making the node precess once per year at radius
    a.  float32, as the reference's (its arccos runs in float32)."""
    n = mean_motion(a)
    cos_i = -C.OMEGA_SUN_SYNC / (1.5 * C.J2_EARTH * n * (C.R_EARTH / a) ** 2)
    return float(np.float32(np.arccos(np.float64(np.float32(cos_i)))))


@dataclass(frozen=True)
class ClusterDesign:
    n_side: int = C.CLUSTER_N_SIDE
    spacing: float = C.CLUSTER_SPACING
    altitude: float = C.CLUSTER_ALTITUDE
    kappa: float = 1.0                 # radial axis-ratio factor (J2 compensation)
    sun_synchronous: bool = True
    energy_matched: bool = False       # used by the J2 integration only

    @property
    def a(self) -> float:
        return C.R_EARTH + self.altitude

    @property
    def n(self) -> float:
        return mean_motion(self.a)

    @property
    def period(self) -> float:
        return float(2.0 * math.pi / self.n)

    @property
    def n_sats(self) -> int:
        return self.n_side ** 2

    def inclination(self) -> float:
        return sun_sync_inclination(self.a) if self.sun_synchronous else 0.0

    def alpha_beta(self) -> np.ndarray:
        return lattice_alpha_beta(self.n_side, self.spacing)
