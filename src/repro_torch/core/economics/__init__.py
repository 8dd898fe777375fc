"""Launch-cost and launched-power-price models (paper §2.4 / §4.4).
Host numpy float64, the port's own copy of the reference's modules of the
same names."""
from .launch import SPACEX_HISTORY, LearningCurve, StarshipCostModel
from .power_price import (CURRENT_LAUNCH_USD_PER_KG, TABLE1_SATELLITES,
                          TARGET_LAUNCH_USD_PER_KG, TERRESTRIAL_RANGE,
                          SatelliteBus, starlink_v2_power_kw,
                          terrestrial_power_cost_per_kw_year)

__all__ = [
    "LearningCurve", "StarshipCostModel", "SPACEX_HISTORY", "SatelliteBus",
    "TABLE1_SATELLITES", "TERRESTRIAL_RANGE", "starlink_v2_power_kw",
    "terrestrial_power_cost_per_kw_year", "CURRENT_LAUNCH_USD_PER_KG",
    "TARGET_LAUNCH_USD_PER_KG",
]
