"""Four-objective Pareto fleet planner: sweep plans, keep the frontier.

The simulator meters one configuration at a time; the planner turns it
into a capacity-planning tool.  ``plan_fleet`` sweeps a grid of plans --
fleet composition / purchase-tier specs, routing policies, spot
preemption rates -- runs each through the cheapest engine that can
replay it (``run_mega`` for warm-first zero-service plans, its bulk
phases on the GPU with ``backend="torch"``; the event loop for
everything else), and reduces
the sweep to the set of plans no other plan beats on ALL of

    (cost_usd, energy_wh, carbon_kg, p99_added_latency_s)

-- the non-dominated frontier (a Pareto-over-plans capacity planner,
generalized to four objectives).

The frontier's single summary number is its **hypervolume** against the
all-on-demand reference plan: objectives are normalized so the
reference sits at (1, 1, 1, 1), values beating the reference land in
[0, 1), values worse than it clip to 1 (no credit), and the reported
volume is the fraction of the unit box the frontier dominates.  0 means
nothing in the sweep beats always-on-demand anywhere; the volume grows
as plans push the corners in.  Exact recursive slicing -- frontiers are
tens of points, not thousands.

Execution comes in two modes.  ``batched=False`` evaluates every grid
point as its own simulation (the legacy shape).  ``batched=True`` (the
default) groups points by structural shape -- ``(fleet, router, rate,
spot-device-set)`` -- because purchase tiers never steer the dynamics
(they only re-price the metered timeline, and the preemption draw
depends on the tier map only through which devices are spot).  One
simulation per group replays through ``torchback.run_mega_sweep`` (the
CUDA libraries loaded once and shared by every point); tier variants
re-price the group's metered reports through ``pricing.price_fleet``,
bit-identical to a fresh run.  Points outside mega scope (stateful
routers, actual fault draws) run the event loop concurrently on a
host thread pool, which never touches the GPU.
"""
from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.catalog import build_fleet
from repro_torch.fleet.fleetsim import (DAY, FleetModel, FleetScenario,
                                  mixed_fleet_scenario, run_fleet)
from repro_torch.fleet.pricing import PreemptionModel, price_fleet
from repro_torch.fleet.router import get_router

OBJECTIVES = ("cost_usd", "energy_wh", "carbon_kg", "p99_s")

# The pinned 3-zone day (the follow-the-sun fleet) and its spot-tier
# variants: the canonical sweep the planner's anchors are pinned on.
ZONES3_FLEET = "2xh100@DEU+2xa100@USA+2xl40s@IND"
SPOT_H100_FLEET = "2xh100@DEU:spot+2xa100@USA+2xl40s@IND"
SPOT_ALL_FLEET = "2xh100@DEU:spot+2xa100@USA:spot+2xl40s@IND:spot"


@dataclasses.dataclass(frozen=True)
class PlanAxes:
    """The sweep grid: every combination of these axes is one plan.

    ``fleets`` are fleet spec strings and may embed per-part zones and
    tiers (``"2xh100@DEU:spot+2xa100"``); ``price_tiers`` sweeps the
    scenario DEFAULT tier that tier-less parts inherit.  A nonzero
    preemption rate attaches a seeded ``PreemptionModel`` (spot-tier
    devices only), so on-demand plans are identical across rates and
    the planner dedupes them by skipping rate > 0 for plans with no
    spot device.
    """
    fleets: Tuple[str, ...]
    routers: Tuple[str, ...] = ("warm-first",)
    price_tiers: Tuple[str, ...] = ("on_demand",)
    preemption_rates: Tuple[float, ...] = (0.0,)
    preemption_warning_s: float = 120.0
    preemption_outage_s: float = 4 * 3600.0
    preemption_seed: int = 0


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    """One evaluated plan: its coordinates on the sweep grid plus the
    four objective values (all minimized) and run provenance."""
    fleet: str
    router: str
    price_tier: str
    preemption_rate: float
    cost_usd: float
    energy_wh: float
    carbon_kg: float
    p99_s: float
    engine: str = ""                # "mega-torch" | "mega-numpy" | "fleet"
    gpu_hours_usd: float = 0.0
    energy_usd: float = 0.0
    preemptions: int = 0
    requests: int = 0
    # wall seconds this point's simulation took (informational, never
    # compared): 0.0 for batched tier variants, which re-price their
    # group's simulation instead of running one; mega-sweep primaries
    # carry an equal share of the batch wall-clock
    eval_s: float = 0.0

    def objectives(self) -> Tuple[float, float, float, float]:
        return (self.cost_usd, self.energy_wh, self.carbon_kg, self.p99_s)

    def label(self) -> str:
        pre = (f" pre={self.preemption_rate:g}/dev-day"
               if self.preemption_rate else "")
        return f"{self.fleet} [{self.router}, {self.price_tier}{pre}]"


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Minimization dominance: a is no worse everywhere, better
    somewhere."""
    return (all(x <= y for x, y in zip(a, b))
            and any(x < y for x, y in zip(a, b)))


def pareto_front(points: Sequence[PlanPoint]) -> List[PlanPoint]:
    """The mutually non-dominated subset, sorted by cost then the other
    objectives (deterministic presentation order).  Exact-duplicate
    objective vectors keep only their first point (a plan tied on every
    objective adds no frontier information)."""
    out: List[PlanPoint] = []
    seen = set()
    for p in points:
        obj = p.objectives()
        if obj in seen:
            continue
        if any(dominates(q.objectives(), obj) for q in points):
            continue
        seen.add(obj)
        out.append(p)
    return sorted(out, key=lambda p: p.objectives())


def _slice_hv(pts: List[Tuple[float, ...]]) -> float:
    """Exact hypervolume of the region of [0, 1]^d dominated by ``pts``
    (minimization; the reference corner is (1, ..., 1)).  Recursive
    slicing on the first objective: sweep its sorted values, and weight
    each slab's width by the (d-1)-dimensional volume the points alive
    in that slab dominate."""
    if not pts:
        return 0.0
    d = len(pts[0])
    if d == 1:
        return 1.0 - min(p[0] for p in pts)
    pts = sorted(pts)
    vol = 0.0
    for i, p in enumerate(pts):
        x1 = pts[i + 1][0] if i + 1 < len(pts) else 1.0
        width = x1 - p[0]
        if width > 0.0:
            vol += width * _slice_hv([q[1:] for q in pts[:i + 1]])
    return vol


def hypervolume(points: Sequence[PlanPoint],
                reference: Sequence[float]) -> float:
    """Normalized 4-objective hypervolume of ``points`` against a
    reference objective vector (e.g. the all-on-demand plan's).

    Each objective is divided by its reference value (a zero reference
    component, e.g. a p99 of exactly 0 s, cannot be beaten: values at
    or under it map to 0, everything else clips to 1) and clipped to
    [0, 1], so the result is the fraction of the unit box between the
    frontier and the reference that the frontier dominates -- 0 when
    nothing beats the reference anywhere, approaching 1 as plans push
    all four corners toward zero.
    """
    norm: List[Tuple[float, ...]] = []
    for p in points:
        q = []
        for o, r in zip(p.objectives(), reference):
            if r > 0.0:
                q.append(min(max(o / r, 0.0), 1.0))
            else:
                q.append(0.0 if o <= r else 1.0)
        norm.append(tuple(q))
    return _slice_hv(norm)


@dataclasses.dataclass
class PlanResult:
    """A finished sweep: every evaluated plan, its non-dominated
    frontier, the all-on-demand reference plan, and the frontier's
    normalized hypervolume against it.

    ``stats`` is the execution provenance: ``{"mode", "wall_s", "sims",
    "points", "compiles"}``.  ``sims`` counts the simulations run
    (batched mode shares one across a group's tier variants).
    ``compiles`` counts the CUDA libraries built or loaded during the
    sweep (``torchback.compiled_program_count``), not jit programs:
    eager PyTorch has none, so a sweep after the first kernel launch on
    the card adds 0, and a CPU sweep always 0."""
    points: List[PlanPoint]
    frontier: List[PlanPoint]
    reference: Optional[PlanPoint]
    hypervolume: float
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    def best(self, objective: str) -> PlanPoint:
        """The frontier's corner point for one objective (ties broken
        by the full objective tuple, so the answer is deterministic).
        Single-objective optima of the sweep are always on the frontier
        -- nothing can dominate a point that is minimal somewhere."""
        if objective not in OBJECTIVES:
            raise KeyError(f"unknown objective {objective!r}; have "
                           f"{OBJECTIVES}")
        return min(self.frontier,
                   key=lambda p: (getattr(p, objective), p.objectives()))

    def to_json(self) -> str:
        """The frontier (plus reference and hypervolume) as a JSON
        document."""
        return json.dumps({
            "objectives": list(OBJECTIVES),
            "hypervolume_vs_on_demand": self.hypervolume,
            "reference": (dataclasses.asdict(self.reference)
                          if self.reference else None),
            "frontier": [dataclasses.asdict(p) for p in self.frontier],
            "n_evaluated": len(self.points),
            "stats": dict(self.stats),
        }, indent=2)


def _scenario_for(base: FleetScenario, fleet: str, router: str,
                  tier: str, rate: float, axes: PlanAxes) -> FleetScenario:
    """One grid point's scenario: the base workload re-fleeted.  Models
    keep their traces; prewarm homes re-assign round-robin over the new
    device list (the same assignment rule as ``mixed_fleet_scenario``,
    so the base scenario itself is reproduced exactly when its own
    coordinates come up)."""
    devices = build_fleet(fleet)
    models = []
    for i, fm in enumerate(base.models):
        home = (devices[i % len(devices)].instance_id
                if fm.spec.home is not None else None)
        models.append(FleetModel(dataclasses.replace(fm.spec, home=home),
                                 fm.arrivals_s))
    pre = None
    if rate > 0.0:
        pre = PreemptionModel(rate_per_device_day=rate,
                              warning_s=axes.preemption_warning_s,
                              outage_s=axes.preemption_outage_s,
                              seed=axes.preemption_seed)
    return dataclasses.replace(base, devices=devices, models=models,
                               router=router, price_tier=tier,
                               preemptions=pre)


def _evaluate(sc: FleetScenario, backend: str,
              device: Optional[str]) -> Tuple[object, str]:
    """Run one plan through the cheapest capable engine: the mega
    simulator when the plan fits its scope, the event loop when it
    does not (stateful routing, service time, consolidation,
    autoscaling, or actual preemption faults)."""
    from repro_torch.fleet.mega import megasim
    try:
        return (megasim.run_mega(sc, compute_bound=False, backend=backend,
                                 device=device), f"mega-{backend}")
    except megasim.MegaUnsupportedError:
        return run_fleet(sc), "fleet"


def _has_spot(sc: FleetScenario) -> bool:
    return "spot" in sc.device_tiers().values()


def _grid(base: FleetScenario, axes: PlanAxes
          ) -> List[Tuple[str, str, str, float, FleetScenario]]:
    """The sweep grid in canonical (serial) order, with construction
    hoisted: each fleet's device list and re-homed models are built
    ONCE and shared by every (router, tier, rate) variant -- so all
    variants replay the IDENTICAL arrival arrays (keeping the mega
    backends' biggap caches, keyed by array identity, hot across the
    whole sweep) -- and each nonzero rate shares one PreemptionModel
    (its draw is pure).  Plans with no spot-tier device skip nonzero
    rates (the draw would be empty; the plan is the rate-0 plan)."""
    parts: Dict[str, Tuple[list, list]] = {}
    pres: Dict[float, PreemptionModel] = {}
    out: List[Tuple[str, str, str, float, FleetScenario]] = []
    for fleet in axes.fleets:
        if fleet not in parts:
            devices = build_fleet(fleet)
            models = []
            for i, fm in enumerate(base.models):
                home = (devices[i % len(devices)].instance_id
                        if fm.spec.home is not None else None)
                models.append(FleetModel(
                    dataclasses.replace(fm.spec, home=home),
                    fm.arrivals_s))
            parts[fleet] = (devices, models)
        devices, models = parts[fleet]
        for router in axes.routers:
            for tier in axes.price_tiers:
                for rate in axes.preemption_rates:
                    pre = None
                    if rate > 0.0:
                        pre = pres.get(rate)
                        if pre is None:
                            pre = pres[rate] = PreemptionModel(
                                rate_per_device_day=rate,
                                warning_s=axes.preemption_warning_s,
                                outage_s=axes.preemption_outage_s,
                                seed=axes.preemption_seed)
                    sc = dataclasses.replace(
                        base, devices=devices, models=models,
                        router=router, price_tier=tier, preemptions=pre)
                    if rate > 0.0 and not _has_spot(sc):
                        continue        # no revocable device: same plan
                    out.append((fleet, router, tier, rate, sc))
    return out


def _point(res, engine: str, fleet: str, router: str, tier: str,
           rate: float, eval_s: float, *,
           cost=None) -> PlanPoint:
    """A PlanPoint from a finished run; ``cost`` re-prices a tier
    variant from the group simulation's reports (CostBreakdown)."""
    return PlanPoint(
        fleet=fleet, router=router, price_tier=tier,
        preemption_rate=rate,
        cost_usd=cost.cost_usd if cost is not None else res.cost_usd,
        energy_wh=res.energy_wh,
        carbon_kg=res.carbon_kg, p99_s=res.p99_added_latency_s,
        engine=engine,
        gpu_hours_usd=(cost.gpu_hours_usd if cost is not None
                       else res.gpu_hours_usd),
        energy_usd=res.energy_usd, preemptions=res.preemptions,
        requests=res.requests, eval_s=eval_s)


def _serial_points(grid, backend: str, device: Optional[str]
                   ) -> Tuple[List[PlanPoint], int]:
    points = []
    for fleet, router, tier, rate, sc in grid:
        t0 = time.perf_counter()
        res, engine = _evaluate(sc, backend, device)
        points.append(_point(res, engine, fleet, router, tier, rate,
                             time.perf_counter() - t0))
    return points, len(points)


def _batched_points(grid, backend: str,
                    max_workers: Optional[int], device: Optional[str]
                    ) -> Tuple[List[PlanPoint], int]:
    """One simulation per structural group.

    Group key ``(fleet, router, rate, spot-device-set)``: members
    differ only in the default purchase tier, which never steers the
    dynamics -- it re-prices the metered timeline, and the preemption
    draw sees the tier map only through which devices resolve to spot
    (pinned in the key).  The group primary (first member in grid
    order) simulates -- mega-scope primaries in one
    ``run_mega_sweep(on_unsupported="skip")`` batch on the torch backend
    (finished, and synchronised, before any worker starts), the rest
    concurrently on a host thread pool running
    ``run_fleet(compute_bound=False, detail=False)`` -- and each tier
    variant re-prices the primary's device reports, bit-identical to
    its own run.  Engine attribution per point matches the serial
    dispatch because scope eligibility is group-uniform.
    """
    from repro_torch.fleet.mega import megasim
    groups: Dict[tuple, List[int]] = {}
    for i, (fleet, router, tier, rate, sc) in enumerate(grid):
        spotset = (frozenset(d for d, t in sc.device_tiers().items()
                             if t == "spot") if rate > 0.0 else None)
        groups.setdefault((fleet, router, rate, spotset), []).append(i)
    primaries = [g[0] for g in groups.values()]

    # phase 1: every primary attempts the mega engine (the guards are
    # cheap); unsupported points come back as None
    results: Dict[int, Tuple[object, str, float]] = {}
    t0 = time.perf_counter()
    if backend == "torch":
        from repro_torch.fleet.mega import torchback
        sweep = torchback.run_mega_sweep(
            scenarios=[grid[i][4] for i in primaries],
            compute_bound=False, on_unsupported="skip", device=device)
    else:
        sweep = []
        for i in primaries:
            try:
                sweep.append(megasim.run_mega(grid[i][4],
                                              compute_bound=False,
                                              backend=backend))
            except megasim.MegaUnsupportedError:
                sweep.append(None)
    mega_wall = time.perf_counter() - t0
    n_mega = sum(1 for r in sweep if r is not None)
    share = mega_wall / n_mega if n_mega else 0.0
    for i, r in zip(primaries, sweep):
        if r is not None:
            results[i] = (r, f"mega-{backend}", share)

    # phase 2: event-loop groups on the worker pool (host only: nothing
    # a worker runs touches the GPU).  Each submission
    # gets a PRIVATE router instance (get_router returns shared
    # stateless singletons; run_fleet re-binds the carbon trace on
    # them, which concurrent runs must not race on).
    ev_idx = [i for i, r in zip(primaries, sweep) if r is None]
    if ev_idx:
        def run_ev(i):
            _f, _r, _t, _rt, sc = grid[i]
            if isinstance(sc.router, str):
                sc = dataclasses.replace(
                    sc, router=copy.copy(get_router(sc.router)))
            t1 = time.perf_counter()
            res = run_fleet(sc, compute_bound=False, detail=False)
            return res, "fleet", time.perf_counter() - t1

        workers = max_workers or min(8, os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=workers) as ex:
            for i, out in zip(ev_idx, ex.map(run_ev, ev_idx)):
                results[i] = out

    # assemble in grid order; tier variants re-price the group run
    points: List[Optional[PlanPoint]] = [None] * len(grid)
    for idxs in groups.values():
        res, engine, eval_s = results[idxs[0]]
        for j in idxs:
            fleet, router, tier, rate, sc = grid[j]
            if j == idxs[0]:
                points[j] = _point(res, engine, fleet, router, tier,
                                   rate, eval_s)
            else:
                cost = price_fleet(sc.devices, res.devices,
                                   default_tier=tier,
                                   energy_usd=res.energy_usd)
                points[j] = _point(res, engine, fleet, router, tier,
                                   rate, 0.0, cost=cost)
    return points, len(primaries)


def plan_fleet(base_scenario: FleetScenario, axes: PlanAxes, *,
               backend: str = "torch", batched: bool = True,
               max_workers: Optional[int] = None,
               device: Optional[str] = None) -> PlanResult:
    """Sweep every plan on the grid and reduce to the 4-objective
    frontier.

    ``base_scenario`` supplies the workload (models, traces, horizon,
    zone, carbon trace); each grid point re-fleets it.  ``backend``
    picks the mega bulk-scan engine for plans inside mega scope:
    ``"torch"`` (bulk phases on ``device``; ``None`` means the GPU, and
    a missing card raises ``RuntimeError`` at the first mega plan) or
    ``"numpy"``.  ``batched`` selects grouped execution (see the
    module docstring; the frontier is point-for-point identical to
    ``batched=False``, property-tested); ``max_workers`` caps the
    event-loop worker pool.

    The reference plan for the hypervolume is the sweep's all-on-demand
    singleton: the first fleet x first router at the ``on_demand``
    default tier with no preemption -- evaluated even when those
    coordinates are not on the grid, so the reported volume always has
    the same meaning.  Plans with no spot-tier device skip nonzero
    preemption rates (the draw would be empty; the plan is the rate-0
    plan, and evaluating it again would only duplicate points).
    """
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend={backend!r}: expected 'torch' or "
                         f"'numpy'")
    from repro_torch.fleet.mega import torchback
    c0 = torchback.compiled_program_count()
    t_start = time.perf_counter()
    grid = _grid(base_scenario, axes)
    if batched:
        points, sims = _batched_points(grid, backend, max_workers, device)
    else:
        points, sims = _serial_points(grid, backend, device)
    reference: Optional[PlanPoint] = None
    for p in points:
        if (p.price_tier == "on_demand" and p.preemption_rate == 0.0
                and p.fleet == axes.fleets[0]
                and p.router == axes.routers[0]
                and ":" not in p.fleet):
            reference = p
            break
    if reference is None:
        # the grid skipped the all-on-demand corner: evaluate it anyway
        # so the hypervolume keeps its fixed meaning (strip per-part
        # tier pins from the first fleet spec)
        bare = "+".join(part.split(":")[0]
                        for part in axes.fleets[0].split("+"))
        sc = _scenario_for(base_scenario, bare, axes.routers[0],
                           "on_demand", 0.0, axes)
        t0 = time.perf_counter()
        res, engine = _evaluate(sc, backend, device)
        reference = _point(res, engine, bare, axes.routers[0],
                           "on_demand", 0.0,
                           time.perf_counter() - t0)
        sims += 1
    frontier = pareto_front(points)
    hv = hypervolume(frontier, reference.objectives())
    stats = {"mode": "batched" if batched else "serial",
             "wall_s": time.perf_counter() - t_start,
             "sims": sims, "points": len(points),
             "compiles": torchback.compiled_program_count() - c0}
    return PlanResult(points=points, frontier=frontier,
                      reference=reference, hypervolume=hv, stats=stats)


# ---------------------------------------------------------------------------
# The pinned sweep (the planner's anchors).
# ---------------------------------------------------------------------------

def pinned_day_base(*, horizon_s: float = DAY,
                    seed: int = 100) -> FleetScenario:
    """The 3-zone seed-100 day (10 models, diurnal zone traces) as the
    planner's base workload, with the zone-preset carbon trace so
    carbon is a live axis."""
    from repro_torch.core.scheduler import Breakeven
    return mixed_fleet_scenario(Breakeven, "warm-first", fleet=ZONES3_FLEET,
                                seed=seed, horizon_s=horizon_s,
                                carbon_trace="zone")


def pinned_day_axes(*, routers: Tuple[str, ...] = ("warm-first",
                                                   "slo-aware"),
                    preemption_rate: float = 2.0) -> PlanAxes:
    """The canonical sweep grid over the pinned day: three fleet/tier
    mixes (all on-demand, spot H100s, all spot) x routers x default
    tiers x {no faults, ``preemption_rate``/device-day with 4 h
    outages}.  With the default two routers this is a 20-plan sweep
    whose frontier holds >=3 mutually non-dominated plans."""
    return PlanAxes(fleets=(ZONES3_FLEET, SPOT_H100_FLEET, SPOT_ALL_FLEET),
                    routers=routers,
                    price_tiers=("on_demand", "reserved"),
                    preemption_rates=(0.0, preemption_rate))
