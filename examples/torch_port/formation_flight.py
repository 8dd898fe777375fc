"""Backprop-through-ODE formation control (PyTorch port, paper
supplementary): train the shared-MLP controller to hold a perturbed 3x3
demo cluster against J2, by reverse-mode autograd through the dopri5
integrator, in float64 on one device.

    PYTHONPATH=src python examples/torch_port/formation_flight.py \
        [--iters N] [--intervals N] [--device cuda|cpu]

It runs on the CUDA card unless `--device cpu` is given.
"""
import argparse

import torch

from repro_torch.core.orbital import (ClusterDesign, ControlProblem, rollout,
                                      train_controller)
from repro_torch.core.orbital.control import init_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30,
                    help="controller training iterations")
    ap.add_argument("--intervals", type=int, default=20,
                    help="control intervals per rollout")
    ap.add_argument("--device", default="cuda",
                    help="torch device to integrate on (default cuda)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu)")

    design = ClusterDesign(n_side=3, spacing=100.0)
    prob = ControlProblem(design=design, u_max=2e-5, control_dt=60.0,
                          substeps=4, dv_weight=1e3)
    print("training controller (backprop through dopri5 rollout)...")
    params, info = train_controller(prob, n_intervals=args.intervals,
                                    iters=args.iters, lr=3e-2,
                                    perturb_scale=8.0, device=device)
    zero = {k: torch.zeros_like(v) for k, v in init_policy(
        torch.Generator(device).manual_seed(0), device=device).items()}
    with torch.no_grad():
        _, free = rollout(zero, prob, info["y0"], 0.0, args.intervals)
    print(f"loss history: {['%.1f' % x for x in info['loss_history'][::5]]}")
    print(f"free-fall RMS position error: {float(free['rms_pos_err']):.2f} m")
    print(f"controlled RMS position error: {info['rms_pos_err']:.2f} m")
    print(f"delta-v spent: {info['dv_per_sat']*1e3:.2f} mm/s per sat "
          f"over {args.intervals*60/60:.0f} min")
    assert info["rms_pos_err"] < float(free["rms_pos_err"])
    print("OK: learned controller beats free fall")


if __name__ == "__main__":
    main()
