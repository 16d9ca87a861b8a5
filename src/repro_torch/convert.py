"""State carried into the port from plain fields and numpy arrays.

The fleet simulators have no weights: their state is a day of traffic
(a ``FleetTrace``) and a carbon-intensity curve (a ``CarbonTrace``).
These functions take that state as plain Python values and numpy
arrays -- the form any other implementation (or a telemetry export)
can hand over -- and return the port's objects.  A day written as
JSON-Lines by ``FleetTrace.to_jsonl`` reads back with
``FleetTrace.from_jsonl`` directly.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.carbon import CarbonTrace
from repro_torch.fleet.mega.traces import FleetTrace, RouteTrace


def fleet_trace_from_numpy(
        name: str, fleet: str, horizon_s: float,
        routes: Iterable[Tuple[str, np.ndarray, float, Optional[str]]],
        seed: Optional[int] = None) -> FleetTrace:
    """A ``FleetTrace`` from its fields: ``routes`` holds one
    ``(route_id, arrivals_s, checkpoint_gb, zone)`` per route, with
    arrival times in seconds since day start."""
    return FleetTrace(
        name=str(name), fleet=str(fleet), horizon_s=float(horizon_s),
        routes=tuple(
            RouteTrace(route_id=str(rid),
                       arrivals_s=np.array(arr, dtype=np.float64),
                       checkpoint_gb=float(gb),
                       zone=None if zone is None else str(zone))
            for rid, arr, gb, zone in routes),
        seed=None if seed is None else int(seed))


def carbon_trace_from_numpy(name: str,
                            points: Sequence[Tuple[float, float]],
                            period_s: float) -> CarbonTrace:
    """A ``CarbonTrace`` from its knots ``((t_s, kg_per_kwh), ...)``
    (any array-like of shape [K, 2]) and its period in seconds."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    return CarbonTrace(name=str(name),
                       points=tuple((float(t), float(v)) for t, v in pts),
                       period_s=float(period_s))
