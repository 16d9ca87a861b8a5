"""Trace-replay frontend for the mega-fleet simulator.

The paper is built on production telemetry (18 days / 335k samples of
H100 fleet data); this module gives the simulators a telemetry-shaped
ingestion schema and a gallery of synthetic production days to replay
at mega scale:

  * ``FleetTrace`` -- a named day: a device inventory (a
    ``build_fleet`` spec string) plus per-route timestamped arrival
    streams (``RouteTrace``).  ``to_scenario`` turns it into the exact
    ``FleetScenario`` shape ``run_fleet``/``run_mega`` consume (homes
    assigned round-robin, VRAM derived from checkpoint size -- the
    ``mixed_fleet_scenario`` conventions).
  * ``to_records`` / ``trace_from_records`` -- a flat, JSON-able record
    form (one ``{"t_s", "route"}`` event row per arrival + a route/
    inventory header), the shape real telemetry exports take, with a
    lossless round trip pinned in tests.
  * Synthetic day generators, all explicitly seeded (same seed =>
    bit-identical trace, pinned in tests) and vectorized (thinned
    homogeneous Poisson -- no per-event Python loop, so million-request
    days generate in milliseconds):
      - ``flash_crowd``     one route's rate spikes by a large factor
                            for a short window (viral moment) on top of
                            everyone's diurnal baseline.
      - ``product_launch``  a new route has EXACTLY zero traffic before
                            launch, then a launch surge decaying to its
                            steady rate.
      - ``regional_outage`` an upstream region drops: NO arrivals reach
                            the fleet during the outage window, then the
                            deferred demand returns as a recovery surge.

Rates are per-route Poisson intensities lambda(t) sampled by thinning:
draw a homogeneous Poisson at the envelope rate, keep each point with
probability lambda(t)/lambda_max -- exact, and fully vectorized.
"""
from __future__ import annotations

import array
import dataclasses
import heapq
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.catalog import build_fleet
from repro_torch.fleet.cluster import FleetModelSpec
from repro_torch.fleet.fleetsim import DAY, FleetModel, FleetScenario

_GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class RouteTrace:
    """One route's day: its arrival timestamps + model footprint.

    ``zone`` optionally names the electricity zone the route's traffic
    originates in (a ``catalog.MIXES`` key); ``to_scenario`` then homes
    the route on that zone's devices when the inventory has any."""
    route_id: str
    arrivals_s: np.ndarray          # seconds since day start, sorted
    checkpoint_gb: float
    zone: Optional[str] = None

    def __post_init__(self):
        arr = np.sort(np.asarray(self.arrivals_s, dtype=np.float64))
        object.__setattr__(self, "arrivals_s", arr)

    @property
    def requests(self) -> int:
        return int(self.arrivals_s.size)


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """A replayable production-shaped day: inventory + per-route streams."""
    name: str
    fleet: str                      # build_fleet spec, e.g. "8xh100+4xa100"
    horizon_s: float
    routes: Tuple[RouteTrace, ...]
    seed: Optional[int] = None      # generator seed (None for ingested data)

    @property
    def requests(self) -> int:
        return sum(r.requests for r in self.routes)

    def to_scenario(self, policy_factory, router: str = "warm-first",
                    **kwargs) -> FleetScenario:
        """Materialize the FleetScenario this trace replays: homes
        round-robin across the inventory, VRAM at 1.1x checkpoint (the
        ``mixed_fleet_scenario`` conventions), extra kwargs passed
        through (e.g. ``carbon_trace=``).  Routes carrying a ``zone``
        home round-robin WITHIN that zone's devices when the inventory
        pins any there (zone-less routes keep the global round-robin)."""
        devices = build_fleet(self.fleet)
        by_zone: Dict[str, List] = {}
        for d in devices:
            if d.zone is not None:
                by_zone.setdefault(d.zone, []).append(d)
        zone_rr: Dict[str, int] = {}
        models: List[FleetModel] = []
        for i, route in enumerate(self.routes):
            pool = by_zone.get(route.zone) if route.zone else None
            if pool:
                k = zone_rr.get(route.zone, 0)
                zone_rr[route.zone] = k + 1
                home = pool[k % len(pool)].instance_id
            else:
                home = devices[i % len(devices)].instance_id
            spec = FleetModelSpec(
                model_id=route.route_id, policy_factory=policy_factory,
                checkpoint_bytes=int(route.checkpoint_gb * _GB),
                vram_gb=route.checkpoint_gb * 1.1,
                home=home)
            models.append(FleetModel(spec, route.arrivals_s))
        return FleetScenario(devices=devices, models=models, router=router,
                             horizon_s=self.horizon_s, **kwargs)

    def to_jsonl(self, path: str | os.PathLike) -> None:
        """Stream the trace to JSON-Lines telemetry: line 1 is the
        header (name / fleet / horizon_s / seed / per-route footprints),
        every following line one ``{"t_s", "route"}`` arrival event in
        global time order -- written incrementally, so a multi-million-
        request day never materializes its event list in memory.
        ``from_jsonl`` reads it back losslessly (pinned in tests);
        timestamps survive the round trip exactly via ``repr`` floats.
        """
        header = {
            "name": self.name,
            "fleet": self.fleet,
            "horizon_s": float(self.horizon_s),
            "seed": self.seed,
            "routes": [{"route": r.route_id,
                        "checkpoint_gb": float(r.checkpoint_gb),
                        **({"zone": r.zone} if r.zone else {})}
                       for r in self.routes],
        }
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header) + "\n")
            # lazy k-way merge over the (already sorted) per-route
            # streams, route id breaking timestamp ties -- the
            # to_records event order, without the event-list buffer

            def _events(route: RouteTrace):
                rid = route.route_id
                return ((float(t), rid) for t in route.arrivals_s)

            for t, rid in heapq.merge(*map(_events, self.routes)):
                fh.write(f'{{"t_s": {t!r}, "route": {json.dumps(rid)}}}\n')

    @classmethod
    def from_jsonl(cls, path: str | os.PathLike) -> "FleetTrace":
        """Stream a ``to_jsonl`` file back into a ``FleetTrace`` --
        line-at-a-time, appending each event to its route's buffer, so
        peak memory is the arrival arrays themselves.  Tolerant of
        unsorted event lines (RouteTrace re-sorts) and of leading blank
        lines before the header; routes declared in the header with no
        events come back zero-traffic.  Malformed input fails with the
        offending line number: unknown route ids, duplicate route ids
        in the header, and missing/malformed ``t_s`` each get their own
        ``ValueError`` (a bad timestamp is NOT an unknown route)."""
        with open(path, "r", encoding="utf-8") as fh:
            hdr_ln = 1
            first = fh.readline()
            while first and not first.strip():   # tolerate leading blanks
                hdr_ln += 1
                first = fh.readline()
            if not first:
                raise ValueError(f"{path}: empty jsonl trace")
            header = json.loads(first)
            per_route: Dict[str, array.array] = {}
            for r in header["routes"]:
                if r["route"] in per_route:
                    raise ValueError(
                        f"{path}:{hdr_ln}: duplicate route id "
                        f"{r['route']!r} in header")
                per_route[r["route"]] = array.array("d")
            for ln, line in enumerate(fh, start=hdr_ln + 1):
                if not line.strip():
                    continue
                e = json.loads(line)
                try:
                    bucket = per_route[e.get("route")]
                except KeyError:
                    raise ValueError(
                        f"{path}:{ln}: event references unknown route "
                        f"{e.get('route')!r}") from None
                t_s = e.get("t_s")
                if t_s is None:
                    raise ValueError(f"{path}:{ln}: event missing 't_s'")
                try:
                    bucket.append(float(t_s))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{path}:{ln}: malformed 't_s' {t_s!r}") from None
        routes = tuple(
            RouteTrace(route_id=r["route"],
                       arrivals_s=np.frombuffer(
                           per_route[r["route"]], dtype=np.float64).copy(),
                       checkpoint_gb=float(r["checkpoint_gb"]),
                       zone=r.get("zone"))
            for r in header["routes"])
        return cls(name=str(header["name"]), fleet=str(header["fleet"]),
                   horizon_s=float(header["horizon_s"]), routes=routes,
                   seed=header.get("seed"))

    def to_records(self) -> Dict:
        """Flat telemetry-export form: a header (inventory + per-route
        footprints) and one timestamped event row per arrival, time-
        ordered across routes -- the shape a real telemetry dump takes,
        and the input ``trace_from_records`` ingests back losslessly."""
        events = [{"t_s": float(t), "route": r.route_id}
                  for r in self.routes for t in r.arrivals_s]
        events.sort(key=lambda e: (e["t_s"], e["route"]))
        return {
            "name": self.name,
            "fleet": self.fleet,
            "horizon_s": float(self.horizon_s),
            "seed": self.seed,
            "routes": [{"route": r.route_id,
                        "checkpoint_gb": float(r.checkpoint_gb),
                        **({"zone": r.zone} if r.zone else {})}
                       for r in self.routes],
            "events": events,
        }


def trace_from_records(records: Dict) -> FleetTrace:
    """Ingest the ``to_records`` telemetry shape (tolerant of unsorted
    event rows; routes listed in the header but absent from the events
    come back as zero-traffic routes)."""
    per_route: Dict[str, List[float]] = {
        r["route"]: [] for r in records["routes"]}
    for e in records["events"]:
        rid = e["route"]
        if rid not in per_route:
            raise ValueError(f"event references unknown route {rid!r}")
        per_route[rid].append(float(e["t_s"]))
    routes = tuple(
        RouteTrace(route_id=r["route"],
                   arrivals_s=np.asarray(per_route[r["route"]],
                                         dtype=np.float64),
                   checkpoint_gb=float(r["checkpoint_gb"]),
                   zone=r.get("zone"))
        for r in records["routes"])
    return FleetTrace(name=str(records["name"]), fleet=str(records["fleet"]),
                      horizon_s=float(records["horizon_s"]), routes=routes,
                      seed=records.get("seed"))


# ---------------------------------------------------------------------------
# Vectorized inhomogeneous-Poisson sampling (thinning).
# ---------------------------------------------------------------------------

def _thinned(rng: np.random.Generator, rate_hr: Callable[[np.ndarray],
             np.ndarray], rate_max_hr: float, horizon_s: float
             ) -> np.ndarray:
    """Exact lambda(t) sample on [0, horizon) by thinning a homogeneous
    envelope -- one Poisson draw + two vectorized passes, no event loop
    (core.traffic's Lewis-Shedler generator is a per-event Python loop
    and would dominate mega-trace generation)."""
    if rate_max_hr <= 0.0:
        return np.empty(0, dtype=np.float64)
    n = rng.poisson(rate_max_hr * horizon_s / 3600.0)
    t = np.sort(rng.uniform(0.0, horizon_s, size=n))
    keep = rng.uniform(0.0, rate_max_hr, size=n) < rate_hr(t)
    return t[keep]


def _diurnal_hr(base_hr: float, t: np.ndarray) -> np.ndarray:
    """A day-shaped baseline: quiet overnight, peaking mid-afternoon."""
    h = (t / 3600.0) % 24.0
    return base_hr * (0.55 + 0.45 * np.sin((h - 9.0) * np.pi / 12.0))


def _route_plan(rng: np.random.Generator, n_routes: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-route (child seed, checkpoint GB) drawn ONCE from the master
    stream, so every route regenerates bit-identically from the trace
    seed regardless of generation order."""
    seeds = rng.integers(0, 2 ** 31 - 1, size=n_routes)
    ckpt_gb = np.round(rng.uniform(4.0, 28.0, size=n_routes), 1)
    return seeds, ckpt_gb


def flash_crowd(*, n_routes: int = 8, fleet: str = "2xh100+2xa100+2xl40s",
                horizon_s: float = DAY, seed: int = 100,
                base_rate_hr: float = 40.0, spike_x: float = 40.0,
                spike_start_s: float = 13 * 3600.0,
                spike_width_s: float = 1800.0) -> FleetTrace:
    """Viral-moment day: route 0's rate multiplies by ``spike_x`` for
    ``spike_width_s`` (sharp rise, exponential cool-down) on top of the
    shared diurnal baseline."""
    rng = np.random.default_rng(seed)
    seeds, ckpt = _route_plan(rng, n_routes)
    routes = []
    for i in range(n_routes):
        child = np.random.default_rng(int(seeds[i]))
        if i == 0:
            tail_s = 2.0 * spike_width_s     # exponential cool-down span

            def rate(t: np.ndarray) -> np.ndarray:
                r = _diurnal_hr(base_rate_hr, t)
                dt = t - spike_start_s
                hot = (dt >= 0.0) & (dt < spike_width_s)
                cool = (dt >= spike_width_s) & (dt < spike_width_s + tail_s)
                boost = np.where(hot, spike_x, 0.0) + np.where(
                    cool, spike_x * np.exp(-(dt - spike_width_s)
                                           / (0.35 * spike_width_s)), 0.0)
                return r * (1.0 + boost)

            rmax = base_rate_hr * (1.0 + spike_x)
        else:
            def rate(t: np.ndarray) -> np.ndarray:
                return _diurnal_hr(base_rate_hr, t)

            rmax = base_rate_hr
        routes.append(RouteTrace(
            route_id=f"r{i}", arrivals_s=_thinned(child, rate, rmax,
                                                  horizon_s),
            checkpoint_gb=float(ckpt[i])))
    return FleetTrace(name="flash-crowd", fleet=fleet, horizon_s=horizon_s,
                      routes=tuple(routes), seed=seed)


def product_launch(*, n_routes: int = 8,
                   fleet: str = "2xh100+2xa100+2xl40s",
                   horizon_s: float = DAY, seed: int = 100,
                   launch_s: float = 9 * 3600.0,
                   launch_rate_hr: float = 600.0,
                   steady_rate_hr: float = 60.0,
                   decay_s: float = 4 * 3600.0,
                   base_rate_hr: float = 40.0) -> FleetTrace:
    """Launch day: route 0 has EXACTLY zero traffic before ``launch_s``
    (the model is not public yet), then a surge at ``launch_rate_hr``
    decaying toward ``steady_rate_hr``; other routes run the diurnal
    baseline."""
    rng = np.random.default_rng(seed)
    seeds, ckpt = _route_plan(rng, n_routes)
    routes = []
    for i in range(n_routes):
        child = np.random.default_rng(int(seeds[i]))
        if i == 0:
            def rate(t: np.ndarray) -> np.ndarray:
                dt = t - launch_s
                surge = steady_rate_hr + (launch_rate_hr - steady_rate_hr) \
                    * np.exp(-np.maximum(dt, 0.0) / decay_s)
                return np.where(dt >= 0.0, surge, 0.0)

            rmax = launch_rate_hr
        else:
            def rate(t: np.ndarray) -> np.ndarray:
                return _diurnal_hr(base_rate_hr, t)

            rmax = base_rate_hr
        routes.append(RouteTrace(
            route_id=f"r{i}", arrivals_s=_thinned(child, rate, rmax,
                                                  horizon_s),
            checkpoint_gb=float(ckpt[i])))
    return FleetTrace(name="product-launch", fleet=fleet,
                      horizon_s=horizon_s, routes=tuple(routes), seed=seed)


def regional_outage(*, n_routes: int = 8,
                    fleet: str = "2xh100+2xa100+2xl40s",
                    horizon_s: float = DAY, seed: int = 100,
                    base_rate_hr: float = 60.0,
                    outage_start_s: float = 11 * 3600.0,
                    outage_s: float = 3600.0,
                    recovery_x: float = 3.0,
                    recovery_s: float = 1800.0) -> FleetTrace:
    """Upstream-region loss: EVERY route sees zero arrivals during
    [outage_start, outage_start + outage_s), then the deferred demand
    returns as a ``recovery_x`` surge over ``recovery_s`` before
    settling back to the diurnal baseline."""
    rng = np.random.default_rng(seed)
    seeds, ckpt = _route_plan(rng, n_routes)
    out0, out1 = outage_start_s, outage_start_s + outage_s

    def rate(t: np.ndarray) -> np.ndarray:
        r = _diurnal_hr(base_rate_hr, t)
        dark = (t >= out0) & (t < out1)
        surge = (t >= out1) & (t < out1 + recovery_s)
        return np.where(dark, 0.0, r * np.where(surge, recovery_x, 1.0))

    rmax = base_rate_hr * recovery_x
    routes = []
    for i in range(n_routes):
        child = np.random.default_rng(int(seeds[i]))
        routes.append(RouteTrace(
            route_id=f"r{i}", arrivals_s=_thinned(child, rate, rmax,
                                                  horizon_s),
            checkpoint_gb=float(ckpt[i])))
    return FleetTrace(name="regional-outage", fleet=fleet,
                      horizon_s=horizon_s, routes=tuple(routes), seed=seed)


GENERATORS: Dict[str, Callable[..., FleetTrace]] = {
    "flash-crowd": flash_crowd,
    "product-launch": product_launch,
    "regional-outage": regional_outage,
}
