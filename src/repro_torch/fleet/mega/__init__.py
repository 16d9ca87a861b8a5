"""Vectorized mega-fleet simulation + production trace replay.

`megasim.run_mega` is an array-program re-expression of
`fleet.fleetsim.run_fleet` for the warm-first / no-controller scope;
its bulk phases run on the GPU through `torchback` by default.
`traces` supplies the telemetry-shaped ingestion schema (`FleetTrace`)
and the synthetic production-day generators that feed it.
"""
from repro_torch.fleet.mega.megasim import MegaUnsupportedError, run_mega
from repro_torch.fleet.mega.traces import (
    GENERATORS,
    FleetTrace,
    RouteTrace,
    flash_crowd,
    product_launch,
    regional_outage,
    trace_from_records,
)

__all__ = [
    "MegaUnsupportedError",
    "run_mega",
    "GENERATORS",
    "FleetTrace",
    "RouteTrace",
    "flash_crowd",
    "product_launch",
    "regional_outage",
    "trace_from_records",
]
