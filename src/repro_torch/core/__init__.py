"""The physics half of the port: the orbital, radiation and ISL models
that set which DiLoCo pods take part in a round.  Host-side numpy, copied
from the reference's modules of the same names (the port imports nothing
of the JAX package)."""
