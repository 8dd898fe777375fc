"""Table 1: launched power price vs terrestrial data-center power spend.
Host numpy."""
import time

from repro_torch.core.economics import (CURRENT_LAUNCH_USD_PER_KG,
                                        TABLE1_SATELLITES,
                                        TARGET_LAUNCH_USD_PER_KG,
                                        TERRESTRIAL_RANGE)


def run():
    t0 = time.time()
    rows = []
    for sat in TABLE1_SATELLITES:
        rows.append({
            "satellite": sat.name, "mass_kg": sat.mass_kg,
            "power_kw": round(sat.power_kw, 1),
            "lifespan_y": sat.lifespan_years,
            "usd_kw_y_at_3600": round(sat.launched_power_price(
                CURRENT_LAUNCH_USD_PER_KG)),
            "usd_kw_y_at_200": round(sat.launched_power_price(
                TARGET_LAUNCH_USD_PER_KG)),
        })
    us = (time.time() - t0) * 1e6
    span = (rows[0]['usd_kw_y_at_200'],
            max(r['usd_kw_y_at_200'] for r in rows))
    derived = (f"launched power ${span[0]}-{span[1]}/kW/y at $200/kg vs"
               f" terrestrial ${TERRESTRIAL_RANGE[0]:.0f}-"
               f"{TERRESTRIAL_RANGE[1]:.0f}/kW/y")
    return [("table1_power_price", us, derived)], rows
