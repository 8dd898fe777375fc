"""Orbital dynamics, formation design, and differentiable formation
control: constants, the analytic HCW lattice, the J2 numerical orbit and
the ML formation controller."""
from . import constants
from .cluster import (ClusterDesign, j2_drift_rate,
                      neighbor_distances, secular_drift_rates,
                      simulate_cluster, simulate_clusters,
                      sun_sync_inclination, tune_axis_ratio)
from .control import ControlProblem, rollout, train_controller
from .dynamics import (accel_j2, accel_point_mass, make_rhs, mean_motion,
                       specific_energy)
from .frames import eci_to_hill, hill_basis, hill_to_eci
from .hcw import hcw_propagate, hcw_state, lattice_alpha_beta, neighbor_pairs
from .integrators import dopri5_step, integrate, integrate_dense, rk4_step

__all__ = [
    "constants", "ClusterDesign", "j2_drift_rate",
    "neighbor_distances", "secular_drift_rates", "simulate_cluster",
    "simulate_clusters", "sun_sync_inclination",
    "tune_axis_ratio", "ControlProblem", "rollout", "train_controller",
    "accel_j2", "accel_point_mass", "make_rhs", "mean_motion",
    "specific_energy", "eci_to_hill", "hill_basis", "hill_to_eci",
    "hcw_propagate", "hcw_state", "lattice_alpha_beta", "neighbor_pairs",
    "dopri5_step", "integrate", "integrate_dense", "rk4_step",
]
