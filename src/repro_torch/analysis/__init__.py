"""The analytic roofline of the port: first-order FLOP and byte models per
architecture and step kind (`analytic.py`), and the three-term roofline
(`roofline.py`), each priced for a `ChipSpec` (`repro_torch.core.system`:
the H100 the port runs on is `H100_SXM`).  The compiled-artifact half of
the reference is `collectives.py` (the per-rank collective count of an
eager run, `hlo.py`'s schema) and `refresh.py` (the dry run's analytic
blocks)."""
from .analytic import (analytic_roofline, attention_flops,
                       expected_collective_bytes, hbm_bytes_per_device,
                       model_flops, useful_flops)
from .roofline import RooflineTerms, roofline

__all__ = ["RooflineTerms", "analytic_roofline", "attention_flops",
           "expected_collective_bytes", "hbm_bytes_per_device",
           "model_flops", "roofline", "useful_flops"]
