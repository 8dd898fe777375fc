"""Orbital geometry of the cluster: constants, the analytic HCW lattice
and the cluster design (the J2 integration waits for ROADMAP A6)."""
from . import constants
from .cluster import ClusterDesign, mean_motion, sun_sync_inclination
from .hcw import hcw_propagate, hcw_state, lattice_alpha_beta, neighbor_pairs

__all__ = ["constants", "ClusterDesign", "mean_motion",
           "sun_sync_inclination", "hcw_propagate", "hcw_state",
           "lattice_alpha_beta", "neighbor_pairs"]
