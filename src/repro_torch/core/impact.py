"""Industry-scale impact model (paper section 6, Eq. 14, Table 5).

    E_park = N * (1 - rho) * P_park_bar * T_year

Sensitivity grid over fleet size, utilization, and the fleet-weighted
parking tax.  Note the paper's "Low" energy scenario pairs the SMALL fleet
with the HIGH utilization (least idle time) and the A100's low tax -- i.e.
each column of Table 5 is the consistent best/typical/worst case, not an
independent per-row sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

T_YEAR_HR = 8760.0
# Single source of truth for the US grid intensity: the paper's "180 kT
# at 462 GWh" pins this value, and fleet/catalog.py DERIVES its
# MIXES["USA"].gwp_kg_per_kwh from it (core cannot import fleet, so the
# dependency points from fleet to here; regression-tested in
# tests/test_carbon.py).
US_GRID_KG_CO2_PER_KWH = 0.39


@dataclasses.dataclass(frozen=True)
class ImpactScenario:
    name: str
    fleet_size: float           # datacenter GPUs
    utilization: float          # rho
    p_park_w: float             # fleet-weighted average parking tax

    @property
    def energy_gwh_per_year(self) -> float:
        watts = self.fleet_size * (1.0 - self.utilization) * self.p_park_w
        return watts * T_YEAR_HR / 1e9  # W*h -> GWh

    @property
    def co2_kt_per_year(self) -> float:
        return self.energy_gwh_per_year * 1e6 * US_GRID_KG_CO2_PER_KWH / 1e6


# Paper Table 5 (Low pairs high utilization + small fleet + A100 tax;
# High pairs low utilization + large fleet + L40S tax).
LOW = ImpactScenario("low", fleet_size=2.0e6, utilization=0.80, p_park_w=26.3)
BASE = ImpactScenario("base", fleet_size=3.76e6, utilization=0.65, p_park_w=40.0)
HIGH = ImpactScenario("high", fleet_size=6.0e6, utilization=0.50, p_park_w=66.4)

TABLE5: List[ImpactScenario] = [LOW, BASE, HIGH]


def sensitivity_grid(
    fleet_sizes=(2.0e6, 3.76e6, 6.0e6),
    utilizations=(0.50, 0.65, 0.80),
    p_parks=(26.3, 40.0, 66.4),
) -> List[ImpactScenario]:
    """Full factorial sweep (27 cells) around the paper's Table 5 anchors."""
    out = []
    for n in fleet_sizes:
        for rho in utilizations:
            for p in p_parks:
                out.append(ImpactScenario(
                    name=f"N={n / 1e6:.2f}M rho={rho:.2f} P={p:.1f}W",
                    fleet_size=n, utilization=rho, p_park_w=p))
    return out
