"""§2.2 J2-drift compensation: numerically tuned in-plane axis ratio, in
float64 on `device`, every kappa in one integration (`tune_axis_ratio`;
each kappa's rate is bitwise its own run's)."""
import time

from repro_torch.core.orbital import ClusterDesign, tune_axis_ratio


def run(fast: bool = True, device="cuda"):
    t0 = time.time()
    kappas = (1.0, 0.999) if fast else (1.0, 0.9995, 0.999, 0.9985, 1.0037)
    best_k, rates = tune_axis_ratio(ClusterDesign(), kappas=kappas,
                                    n_orbits=6.0, device=device)
    us = (time.time() - t0) * 1e6 / len(kappas)
    base = rates[1.0]
    derived = (f"uncompensated {base:.1f} m/s/yr/km; tuned kappa={best_k}"
               f" -> {rates[best_k]:.1f} m/s/yr/km"
               f" ({base/max(rates[best_k],1e-9):.1f}x reduction; paper: <3"
               f" at its 2:1.0037 convention)")
    return [("j2_drift_compensation", us, derived)], rates
