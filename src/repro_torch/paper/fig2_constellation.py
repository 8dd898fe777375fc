"""Figures 2+3: 81-satellite free-fall constellation over one orbit under
gravity + J2, in float64 on `device`: bounded 2:1 cluster, two
shape-cycles, 100-200 m neighbors."""
import math
import time

import torch

from repro_torch.core.orbital import (ClusterDesign, neighbor_distances,
                                      simulate_cluster)


def run(device="cuda"):
    t0 = time.time()
    d = ClusterDesign()
    ts, hill, rel_inertial = simulate_cluster(d, n_orbits=1.0, dt=5.0,
                                              device=device)
    direct, diag = neighbor_distances(hill)
    ymax = hill[..., 1].abs().max().item()
    xmax = hill[..., 0].abs().max().item()
    us = (time.time() - t0) * 1e6
    derived = (f"81 sats; ellipse {ymax:.0f}x{xmax:.0f}m (ratio "
               f"{ymax/xmax:.2f}:1); direct-neighbor "
               f"{direct.min().item():.0f}-{direct.max().item():.0f}m; "
               f"diag {diag.min().item():.0f}-{diag.max().item():.0f}m; "
               f"sun-sync incl "
               f"{math.degrees(d.inclination(torch.float64)):.2f}deg")
    return [("fig2_fig3_constellation", us, derived)], {
        "ts": ts, "hill": hill, "direct": direct, "diag": diag}
