"""Design studio (PyTorch port): size a space datacenter: formation, ISL
bandwidths, radiation-driven checkpoint cadence, launch economics (paper
§1.2 pipeline).

    PYTHONPATH=src python examples/torch_port/constellation_design.py

The studio is host numpy in float64 (the reference runs it under
jax_enable_x64) and prints what the reference example prints.  Nothing
here runs on a device, so unlike the other examples it takes no
`--device`.
"""
import numpy as np
import torch

from repro_torch.core import SpaceCluster
from repro_torch.core.isl import ISLNetwork
from repro_torch.core.orbital import ClusterDesign, hcw_state


def main():
    cluster = SpaceCluster()
    print("== SpaceCluster summary ==")
    for k, v in cluster.summary().items():
        print(f"  {k}: {v:,.2f}" if isinstance(v, float) else
              f"  {k}: {v}")

    design = ClusterDesign()
    pos = hcw_state(design.alpha_beta(torch.float64), design.n, 0.0,
                    dtype=np.float64)[..., :3]
    net = ISLNetwork()
    edges, caps = net.neighbor_graph(pos, k=8)
    print(f"\n== ISL topology at t=0 ({len(edges)} links) ==")
    print(f"  min link {caps.min()/1e12:.1f} Tbps, "
          f"median {np.median(caps)/1e12:.1f} Tbps")

    print("\n== launch economics ==")
    for price in (3600.0, 200.0):
        print(f"  at ${price:.0f}/kg: cluster launch "
              f"${cluster.launch_cost_usd(price)/1e6:.0f}M, power price "
              f"${cluster.launched_power_price(price):,.0f}/kW/y")


if __name__ == "__main__":
    main()
