"""State carried into the port from plain fields and numpy arrays.

The fleet simulators have no weights: their state is a day of traffic
(a ``FleetTrace``) and a carbon-intensity curve (a ``CarbonTrace``).
The models' state is a parameter tree and a KV-cache tree: nested dicts
of arrays, with the reference's keys and einsum layouts
(``wq [d, hq, k]``, ``wo [hq, k, d]``, stacked ``[layers, ...]``), so a
tree exported from any implementation (``np.asarray`` of each leaf)
carries over as a plain copy.  These functions take that state as plain
Python values and numpy arrays and return the port's objects.  A day
written as JSON-Lines by ``FleetTrace.to_jsonl`` reads back with
``FleetTrace.from_jsonl`` directly.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fleet.carbon import CarbonTrace
from repro_torch.fleet.mega.traces import FleetTrace, RouteTrace
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_param_specs

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16, "float16": torch.float16,
                 "int8": torch.int8, "int32": torch.int32}


def _tensor(arr: Any, dtype: Optional[torch.dtype],
            device: str | torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"unsupported array dtype {name}")
    # numpy has no bfloat16 of its own: widen exactly to float32 first
    host = arr.astype(np.float32) if name == "bfloat16" else arr
    t = torch.from_numpy(np.array(host, order="C"))     # a writable copy
    return t.to(device=device, dtype=dtype or _TORCH_DTYPES[name])


def params_from_numpy(cfg: ArchConfig, tree: Any,
                      device: str | torch.device = "cuda") -> Any:
    """The port's parameters of ``cfg`` from a nested dict of arrays
    with the reference's keys and shapes; each leaf is checked against
    ``build_param_specs(cfg)`` and cast to its spec dtype on
    ``device``."""
    def walk(specs, arrs, path):
        if isinstance(specs, dict):
            if set(specs) != set(arrs):
                raise KeyError(f"{path or 'params'}: keys {sorted(arrs)} "
                               f"!= {sorted(specs)}")
            return {k: walk(specs[k], arrs[k], f"{path}[{k!r}]")
                    for k in specs}
        if tuple(np.shape(arrs)) != specs.shape:
            raise ValueError(f"{path}: shape {np.shape(arrs)} != "
                             f"{specs.shape}")
        return _tensor(arrs, specs.dtype, device)

    return walk(build_param_specs(cfg), tree, "")


def caches_from_numpy(tree: Any,
                      device: str | torch.device = "cuda") -> Any:
    """A cache tree (nested dicts of arrays in the reference's layouts:
    KV caches ``[layers, batch, kv_len, kv_heads, hdim]``, recurrent
    states ``[layers, batch, ...]``) as tensors on ``device``, each in
    its own dtype."""
    if isinstance(tree, dict):
        return {k: caches_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, None, device)


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
