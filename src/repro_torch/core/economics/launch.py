"""Launch-cost analysis (paper §2.4 / §4.4, Fig. 4).

Two independent projections, both reproduced here:

1. Learning-curve: SpaceX $/kg falls ~20% per doubling of cumulative mass
   launched. Anchored at the Falcon Heavy introduction (~$1,800/kg at ~400 t
   cumulative), reaching <=$200/kg needs ~370,000 t more mass (~1,800
   Starship launches at 200 t) — ~180/yr puts that at ~2035. A 72% lower
   total (~104,000 t) still gives ~$300/kg.

2. Bottom-up Starship cost: vehicle amortized over N reuses + refurbishment
   + propellant. Defaults calibrated to the paper's proof points:
   ~$460/kg with no reuse, ~$60/kg at 10x reuse, <~$20/kg at 100x reuse,
   with propellant (~$8/kg payload) as the eventual floor.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LearningCurve:
    """price(cum_mass) = p0 * (cum/cum0)^log2(1 - learning_rate)."""
    p0_usd_per_kg: float = 1800.0      # Falcon Heavy introduction
    cum0_tonnes: float = 400.0         # cumulative mass at that point
    learning_rate: float = 0.20        # ~18-24% supported by the data

    @property
    def exponent(self) -> float:
        return float(np.log2(1.0 - self.learning_rate))

    def price(self, cum_tonnes):
        cum = np.asarray(cum_tonnes, dtype=float)
        return self.p0_usd_per_kg * (cum / self.cum0_tonnes) ** self.exponent

    def cumulative_mass_for_price(self, target_usd_per_kg: float) -> float:
        """Total cumulative tonnes at which price hits the target."""
        ratio = target_usd_per_kg / self.p0_usd_per_kg
        return float(self.cum0_tonnes * ratio ** (1.0 / self.exponent))

    def additional_mass_for_price(self, target_usd_per_kg: float) -> float:
        return self.cumulative_mass_for_price(target_usd_per_kg) - \
            self.cum0_tonnes

    def starship_launches_for_price(self, target_usd_per_kg: float,
                                    payload_tonnes: float = 200.0) -> float:
        return self.additional_mass_for_price(target_usd_per_kg) / \
            payload_tonnes

    def year_reached(self, target_usd_per_kg: float,
                     launches_per_year: float = 180.0,
                     payload_tonnes: float = 200.0,
                     start_year: float = 2025.0) -> float:
        return start_year + self.starship_launches_for_price(
            target_usd_per_kg, payload_tonnes) / launches_per_year


# Historical anchor points for Fig. 4 (inflation-adjusted $/kg, cumulative t)
SPACEX_HISTORY = [
    # (vehicle, cumulative tonnes at introduction, $/kg)
    ("Falcon 1", 0.5, 30000.0),
    ("Falcon 9", 10.0, 5500.0),
    ("Falcon 9 (reusable)", 150.0, 3600.0),
    ("Falcon Heavy", 400.0, 1800.0),
]


@dataclass(frozen=True)
class StarshipCostModel:
    """Bottom-up per-launch cost. All dollars."""
    vehicle_cost: float = 90e6          # booster + ship build cost
    payload_tonnes: float = 200.0       # Starship 4 class
    refurb_frac_per_launch: float = 0.01  # of vehicle cost, per launch
    propellant_cost: float = 1.6e6      # ~3500 t LOX @$200/t + ~1100 t CH4 @$700/t
    ops_cost: float = 0.1e6             # range/ops per launch

    def cost_per_launch(self, reuse: int) -> float:
        amortized = self.vehicle_cost / max(1, reuse)
        refurb = self.refurb_frac_per_launch * self.vehicle_cost \
            if reuse > 1 else 0.0
        return amortized + refurb + self.propellant_cost + self.ops_cost

    def cost_per_kg(self, reuse: int) -> float:
        return self.cost_per_launch(reuse) / (self.payload_tonnes * 1000.0)

    def price_per_kg(self, reuse: int, margin: float = 0.0) -> float:
        """Customer price at a given SpaceX gross margin (paper: up to 75%)."""
        return self.cost_per_kg(reuse) / (1.0 - margin)

    def propellant_floor_per_kg(self) -> float:
        return self.propellant_cost / (self.payload_tonnes * 1000.0)
