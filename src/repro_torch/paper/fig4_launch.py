"""Figure 4 + §2.4: learning-curve and Starship cost projections.  Host
numpy."""
import time

from repro_torch.core.economics import (SPACEX_HISTORY, LearningCurve,
                                        StarshipCostModel)


def run():
    t0 = time.time()
    lc = LearningCurve()
    sm = StarshipCostModel()
    rows = {
        "history": SPACEX_HISTORY,
        "mass_for_200_t": lc.additional_mass_for_price(200.0),
        "launches_for_200": lc.starship_launches_for_price(200.0),
        "year_200_at_180py": lc.year_reached(200.0, 180.0),
        "mass_for_300_t": lc.additional_mass_for_price(300.0),
        "starship_no_reuse": sm.cost_per_kg(1),
        "starship_10x": sm.cost_per_kg(10),
        "starship_100x": sm.cost_per_kg(100),
        "price_10x_75margin": sm.price_per_kg(10, 0.75),
        "propellant_floor": sm.propellant_floor_per_kg(),
    }
    us = (time.time() - t0) * 1e6
    derived = (f"$200/kg needs {rows['mass_for_200_t']/1e3:.0f}kt"
               f" (~{rows['launches_for_200']:.0f} launches) ->"
               f" ~{rows['year_200_at_180py']:.0f};"
               f" Starship $/kg: {rows['starship_no_reuse']:.0f}(1x)/"
               f"{rows['starship_10x']:.0f}(10x)/"
               f"{rows['starship_100x']:.0f}(100x);"
               f" fuel floor ${rows['propellant_floor']:.0f}/kg")
    return [("fig4_launch_curve", us, derived)], rows
