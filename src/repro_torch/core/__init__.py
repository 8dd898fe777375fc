"""The paper's contributions in the port: orbital formation flight, FSO
inter-satellite links, radiation effects and launch economics, and their
composition into a space-datacenter system spec (`system.py`).  Host-side
numpy, and torch for the orbit and the controller; the port's own copies
of the reference's modules of the same names (the port imports nothing of
the JAX package)."""
from .system import H100_SXM, ChipSpec, SatelliteSpec, SpaceCluster

__all__ = ["ChipSpec", "H100_SXM", "SatelliteSpec", "SpaceCluster"]
