"""Physical constants for orbital dynamics (SI units, WGS-84 / EGM-96 values).

The paper (§4.1) models satellite motion under Newtonian point-mass gravity
plus the leading J2 "Earth oblateness" term of the geopotential, which at the
650 km target altitude dominates all other non-Keplerian perturbations.
"""

MU_EARTH = 3.986004418e14        # [m^3/s^2] gravitational parameter
R_EARTH = 6378137.0              # [m] WGS-84 equatorial radius
J2_EARTH = 1.08262668e-3         # [-] second zonal harmonic
SECONDS_PER_YEAR = 365.2421897 * 86400.0
OMEGA_SUN_SYNC = 2.0 * 3.141592653589793 / SECONDS_PER_YEAR  # [rad/s] required nodal precession

# Paper's illustrative cluster (§2.2, Fig. 2/3)
CLUSTER_ALTITUDE = 650e3         # [m] mean cluster altitude
CLUSTER_RADIUS = 1000.0          # [m] R = 1 km
CLUSTER_N_SIDE = 9               # 81 satellites on a 9x9 square lattice
CLUSTER_SPACING = 100.0          # [m] lattice spacing -> 100-200 m neighbor oscillation
J2_AXIS_RATIO = 1.0037           # paper: 2 : 1.0037 in-plane axis-ratio compensation
