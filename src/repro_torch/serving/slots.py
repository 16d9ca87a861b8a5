"""Slot/occupancy primitives shared by the live serving engine and the
fleet simulator.

Both execution models are the same shape: a fixed number of decode
*slots* per model (continuous batching -- vLLM-style admission into a
static working set), plus, at fleet scale, one serialized *loader
channel* per device (weight ingest is PCIe/storage-bound, so loads
queue; decode does not).  ``SlotPool`` is the occupancy tracker
``ServingEngine`` uses for its KV-cache rows and ``DeviceRuntime``
uses per replica; ``DeviceRuntime`` is the multi-slot per-device state
the fleet event loop drives (it replaces the old single ``busy`` flag,
so loads overlap serving and up to ``max_batch`` requests per model
decode concurrently).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

#: Loader-channel sentinel: the device is running its SLEEP -> BARE wake
#: ramp (core/power_states.py).  Wake serializes on the same channel as
#: loads -- a gated device must finish waking before any weight ingest
#: starts -- and the sentinel can never collide with a model_id.
WAKE_CHANNEL = "__wake__"


class SlotPool:
    """Fixed-size pool of reusable slot ids (lowest-free-first).

    The acquire/release discipline is the whole continuous-batching
    contract: a released slot is immediately reusable, and the pool
    never grows, so downstream state keyed by slot id (KV-cache rows,
    in-flight decode events) stays statically shaped.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._live: List[bool] = [False] * n_slots

    def acquire(self) -> Optional[int]:
        """Claim the lowest free slot id, or None when full."""
        for i, live in enumerate(self._live):
            if not live:
                self._live[i] = True
                return i
        return None

    def release(self, slot: int) -> None:
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        self._live[slot] = False

    def is_live(self, slot: int) -> bool:
        return self._live[slot]

    @property
    def busy(self) -> int:
        return sum(self._live)

    @property
    def free(self) -> int:
        return self.n_slots - self.busy

    @property
    def full(self) -> bool:
        return self.busy == self.n_slots

    def live_slots(self) -> List[int]:
        return [i for i, live in enumerate(self._live) if live]

    def free_slots(self) -> List[int]:
        return [i for i, live in enumerate(self._live) if not live]

    def utilization(self) -> float:
        return self.busy / self.n_slots


class DeviceRuntime:
    """Concurrent per-device runtime state for the fleet event loop.

    One serialized loader channel (``loading`` + ``load_q``) and one
    ``SlotPool`` of ``max_batch`` decode slots per resident model:
    a device can stream weights for model A while models B and C decode,
    and each model serves up to ``max_batch`` requests concurrently.
    Requests that find their model cold or its pool full park in a
    per-model ``wait_q`` (their pins keep the replica from evicting).
    """

    def __init__(self, max_batch: int = 4):
        if max_batch < 1:
            raise ValueError("need at least one decode slot per model")
        self.max_batch = max_batch
        self.loading: Optional[str] = None      # model_id mid-load
        self.loading_until: float = 0.0         # sim time the load lands
        # ("load", model_id) | ("mig", src_device_id, model_id)
        self.load_q: Deque[Tuple] = deque()
        self.load_queued: Set[str] = set()      # model_ids queued/in-flight
        self._pools: Dict[str, SlotPool] = {}
        self._waiting: Dict[str, Deque[float]] = {}

    # -- per-model views ----------------------------------------------------
    def pool(self, model_id: str) -> SlotPool:
        if model_id not in self._pools:
            self._pools[model_id] = SlotPool(self.max_batch)
        return self._pools[model_id]

    def wait_q(self, model_id: str) -> Deque[float]:
        if model_id not in self._waiting:
            self._waiting[model_id] = deque()
        return self._waiting[model_id]

    # -- aggregates (router / consolidator signals) -------------------------
    def busy_slots(self, model_id: Optional[str] = None) -> int:
        if model_id is not None:
            p = self._pools.get(model_id)
            return p.busy if p else 0
        return sum(p.busy for p in self._pools.values())

    def waiting_count(self, model_id: Optional[str] = None) -> int:
        if model_id is not None:
            q = self._waiting.get(model_id)
            return len(q) if q else 0
        return sum(len(q) for q in self._waiting.values())

    @property
    def busy(self) -> bool:
        """Any in-flight or queued work (the consolidator's skip signal)."""
        return (self.loading is not None or bool(self.load_q)
                or self.busy_slots() > 0 or self.waiting_count() > 0)
