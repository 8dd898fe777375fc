"""Launched-power price analysis (paper §4.4, Table 1).

$/kW/year launched to LEO = mass * launch_price / (power * lifespan),
compared against terrestrial data-center power spend
(electricity price * 8766 h * PUE).
"""
from __future__ import annotations

from dataclasses import dataclass

SOLAR_INSOLATION_KW_M2 = 1.361
HOURS_PER_YEAR = 8766.0

CURRENT_LAUNCH_USD_PER_KG = 3600.0     # Falcon 9 reusable (Starlink's ride)
TARGET_LAUNCH_USD_PER_KG = 200.0


@dataclass(frozen=True)
class SatelliteBus:
    name: str
    mass_kg: float
    power_kw: float
    lifespan_years: float

    def launched_power_price(self, usd_per_kg: float) -> float:
        """$/kW/year, launch cost amortized over satellite lifetime."""
        return self.mass_kg * usd_per_kg / (self.power_kw *
                                            self.lifespan_years)


def starlink_v2_power_kw(panel_area_m2: float = 105.0,
                         efficiency: float = 0.22,
                         packing: float = 0.90) -> float:
    """~28 kW from photometric panel-area estimates (paper's method)."""
    return panel_area_m2 * efficiency * packing * SOLAR_INSOLATION_KW_M2


# Table 1 rows
STARLINK_V2_MINI = SatelliteBus("Starlink v2 mini", 575.0,
                                starlink_v2_power_kw(), 5.0)
STARLINK_V1 = SatelliteBus("Starlink v1", 260.0, 7.0, 5.0)
ONEWEB = SatelliteBus("OneWeb", 150.0, 0.8, 5.0)
IRIDIUM_NEXT = SatelliteBus("Iridium NEXT", 860.0, 2.0, 12.5)

TABLE1_SATELLITES = [STARLINK_V2_MINI, STARLINK_V1, ONEWEB, IRIDIUM_NEXT]


def terrestrial_power_cost_per_kw_year(usd_per_kwh: float,
                                       pue: float) -> float:
    """US DC annual power spend: $570-3,000/kW/y for $0.06-0.25/kWh,
    PUE 1.09-1.4."""
    return usd_per_kwh * HOURS_PER_YEAR * pue


TERRESTRIAL_RANGE = (
    terrestrial_power_cost_per_kw_year(0.06, 1.09),
    terrestrial_power_cost_per_kw_year(0.25, 1.40),
)
