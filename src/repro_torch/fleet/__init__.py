"""Fleet orchestration: cluster-scale parking-tax simulation, placement,
routing, replica autoscaling, and carbon-intensity-aware scheduling
across heterogeneous GPUs."""
from repro_torch.fleet.autoscaler import (ReplicaAutoscaler, ScaleIn,
                                          ScaleOut)
from repro_torch.fleet.carbon import (CarbonBreakeven, CarbonTrace,
                                      TRACE_SHAPES, carbon_timeline_kg,
                                      carbon_timeline_multi_kg, flat_trace,
                                      make_trace, resolve_zone_trace,
                                      solar_duck, trace_for_zone,
                                      wind_night)
from repro_torch.fleet.catalog import (CATALOG, MIXES, PRICE_TIERS,
                                       DeviceInstance, ElectricityMix,
                                       GPUSku, above_base_load_j,
                                       build_fleet, carbon_kg,
                                       energy_cost_usd, fleet_price_usd,
                                       get_mix, get_sku, marginal_park_w,
                                       normalize_tier, scaleout_cost_j,
                                       transfer_cost_j, transfer_latency_s,
                                       wake_cost_j, zone_hops)
from repro_torch.fleet.cluster import (Cluster, FleetModelSpec,
                                       RateEstimator)
from repro_torch.fleet.router import (BreakevenRouter, CarbonAwareRouter,
                                      Consolidator, EnergyGreedyRouter,
                                      LeastLoadedRouter, Move, ROUTERS,
                                      Router, SLOAwareRouter,
                                      WarmFirstRouter, get_router)
from repro_torch.fleet.fleetsim import (DeviceReport, FleetModel,
                                        FleetResult, FleetScenario,
                                        clairvoyant_bound,
                                        mixed_fleet_scenario, run_fleet,
                                        single_device_scenario,
                                        zone_decomposition)
from repro_torch.fleet.mega import (FleetTrace, GENERATORS,
                                    MegaUnsupportedError, RouteTrace,
                                    flash_crowd, product_launch,
                                    regional_outage, run_mega,
                                    trace_from_records)
from repro_torch.fleet.planner import (OBJECTIVES, PlanAxes, PlanPoint,
                                       PlanResult, dominates, hypervolume,
                                       pareto_front, plan_fleet)
from repro_torch.fleet.pricing import (UNBILLED_STATES, CostBreakdown,
                                       PreemptionModel, Revocation,
                                       billed_seconds, device_gpu_usd,
                                       device_tier_map, price_fleet)

__all__ = [
    "CATALOG", "MIXES", "DeviceInstance", "ElectricityMix", "GPUSku",
    "build_fleet", "carbon_kg", "energy_cost_usd", "fleet_price_usd",
    "get_mix", "get_sku", "above_base_load_j", "marginal_park_w",
    "scaleout_cost_j", "transfer_cost_j", "transfer_latency_s",
    "wake_cost_j", "zone_hops",
    "CarbonBreakeven", "CarbonTrace", "TRACE_SHAPES", "carbon_timeline_kg",
    "carbon_timeline_multi_kg", "flat_trace", "make_trace",
    "resolve_zone_trace", "solar_duck", "trace_for_zone", "wind_night",
    "ReplicaAutoscaler", "ScaleOut", "ScaleIn",
    "Cluster", "FleetModelSpec", "RateEstimator",
    "Router", "ROUTERS", "WarmFirstRouter", "LeastLoadedRouter",
    "EnergyGreedyRouter", "BreakevenRouter", "SLOAwareRouter",
    "CarbonAwareRouter", "Consolidator", "Move", "get_router",
    "FleetModel", "FleetScenario", "FleetResult", "DeviceReport",
    "run_fleet", "single_device_scenario", "mixed_fleet_scenario",
    "clairvoyant_bound", "zone_decomposition",
    "MegaUnsupportedError", "run_mega", "run_mega_sweep", "GENERATORS",
    "FleetTrace", "RouteTrace", "flash_crowd", "product_launch",
    "regional_outage", "trace_from_records",
    "OBJECTIVES", "PlanAxes", "PlanPoint", "PlanResult", "dominates",
    "hypervolume", "pareto_front", "plan_fleet",
    "PRICE_TIERS", "normalize_tier", "UNBILLED_STATES", "CostBreakdown",
    "PreemptionModel", "Revocation", "billed_seconds", "device_gpu_usd",
    "device_tier_map", "price_fleet",
]


def __getattr__(name):
    # the sweep entry point is resolved lazily by the mega package
    if name == "run_mega_sweep":
        from repro_torch.fleet import mega
        return mega.run_mega_sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
