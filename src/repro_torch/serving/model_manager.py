"""Multi-model lifecycle manager: the paper's breakeven scheduling as a
first-class serving feature.

``ModelManager`` owns a device's energy state (EnergyMeter) and a set of
registered models.  Each model carries a per-arch ``LoaderSpec`` (derived
from its checkpoint bytes -- coldstart.loader_from_checkpoint) and an
eviction ``Policy`` (core/scheduler.py).  On request arrival the manager
cold-starts if needed (charging loading energy + latency), serves, and
arms the policy's idle timeout; ``tick()`` applies due evictions.

Node-failure handling: ``fail()`` simulates a device loss -- resident
models drop, the meter resets to bare, and the next request transparently
reloads (the serving-side analogue of checkpoint/restart; see
tests/test_serving.py).

Fleet hooks (repro_torch.fleet): loads are split-phase (``begin_load`` /
``finish_load``) so a cluster event loop can interleave other devices'
evictions with an in-flight load, and ``unload`` / ``export_model`` /
``prewarm`` give the consolidation pass the migration primitives it
needs.  ``handle_request`` keeps the original blocking behaviour.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.coldstart import LoaderSpec, loader_from_checkpoint
from repro_torch.core.power_model import DeviceProfile
from repro_torch.core.power_states import PowerState
from repro_torch.core.scheduler import Policy
from repro_torch.serving.energy import EnergyMeter, SimClock

Tree = Any


@dataclasses.dataclass
class ManagedModel:
    model_id: str
    loader: LoaderSpec
    policy: Policy
    load_fn: Optional[Callable[[], Any]] = None   # returns engine/params
    engine: Any = None
    resident: bool = False
    loading: bool = False
    vram_gb: float = 0.0                          # capacity accounting only
    evict_at: float = math.inf
    pins: int = 0          # queued demand holding the model (fleet layer)
    # autoscaler-held replica: exempt from the policy's idle timeout --
    # it stays warm through lulls (paying the parking tax) until the
    # autoscaler's own breakeven scale-in test retires it
    held: bool = False
    cold_starts: int = 0
    requests: int = 0
    added_latency_s: float = 0.0
    # per-request added latency (queue wait + cold start), one entry per
    # served request -- the fleet layer aggregates these into p50/p99
    latency_samples: List[float] = dataclasses.field(default_factory=list)


class ModelManager:
    def __init__(self, profile: DeviceProfile, *,
                 clock: Optional[SimClock] = None):
        self.profile = profile
        self.clock = clock or SimClock()
        self.meter = EnergyMeter(profile, self.clock)
        self.models: Dict[str, ManagedModel] = {}

    # -- registry -----------------------------------------------------------
    def register(self, model_id: str, *, policy: Policy,
                 loader: Optional[LoaderSpec] = None,
                 checkpoint_bytes: Optional[int] = None,
                 load_fn: Optional[Callable[[], Any]] = None,
                 vram_gb: float = 0.0) -> ManagedModel:
        if loader is None:
            if checkpoint_bytes is None:
                raise ValueError("need loader or checkpoint_bytes")
            loader = loader_from_checkpoint(model_id, checkpoint_bytes,
                                            self.profile)
        policy.reset()
        m = ManagedModel(model_id=model_id, loader=loader, policy=policy,
                         load_fn=load_fn, vram_gb=vram_gb)
        self.models[model_id] = m
        return m

    def _any_resident(self) -> bool:
        return any(m.resident for m in self.models.values())

    def resident_ids(self) -> List[str]:
        return [mid for mid, m in self.models.items() if m.resident]

    def vram_used_gb(self) -> float:
        return sum(m.vram_gb for m in self.models.values()
                   if m.resident or m.loading)

    # -- lifecycle ------------------------------------------------------------
    def begin_load(self, model_id: str) -> float:
        """Enter the loading state WITHOUT advancing time; returns t_load.

        The fleet event loop uses the split-phase form so evictions on
        other devices (sharing this SimClock) land mid-load at the right
        instant."""
        m = self.models[model_id]
        m.loading = True
        self.meter.transition(PowerState.LOADING,
                              power_override_w=m.loader.p_load_w)
        return m.loader.t_load_s

    def finish_load(self, model_id: str) -> None:
        m = self.models[model_id]
        m.cold_starts += 1
        if m.load_fn is not None:
            m.engine = m.load_fn()
        m.loading = False
        m.resident = True
        self.meter.transition(PowerState.CTX_IDLE)

    def _load(self, m: ManagedModel) -> None:
        self.begin_load(m.model_id)
        self.clock.advance(m.loader.t_load_s)
        self.finish_load(m.model_id)

    def _evict(self, m: ManagedModel) -> None:
        m.engine = None                      # frees device buffers
        m.resident = False
        m.evict_at = math.inf
        m.held = False
        # only fall to bare from parked: mid-load/mid-service the burst
        # power keeps metering until that phase closes
        if not self._any_resident() and self.meter.state is PowerState.CTX_IDLE:
            self.meter.transition(PowerState.BARE)

    def unload(self, model_id: str) -> bool:
        """Graceful unload hook (fleet migration): evict now, regardless
        of the armed idle timeout.  Returns whether it was resident."""
        m = self.models[model_id]
        if m.loading:
            raise RuntimeError(
                f"cannot unload {model_id!r}: split-phase load in flight "
                f"(finish_load it first)")
        was = m.resident
        if was:
            self._evict(m)
        return was

    def export_model(self, model_id: str) -> ManagedModel:
        """Unload and remove from the registry, returning the record so a
        migration can re-home the model (engine handle, loader, stats)."""
        self.unload(model_id)
        return self.models.pop(model_id)

    def prewarm(self, model_id: str, *, count_cold_start: bool = True) -> None:
        """Make a model resident NOW without charging load energy/time.

        This is the simulator's ``start_warm`` convention (paper Table 6
        counts the initial load as 1 cold start but starts the horizon
        warm); the fleet uses it for warm-everywhere baselines."""
        m = self.models[model_id]
        if m.resident:
            return
        if m.load_fn is not None:
            m.engine = m.load_fn()
        m.resident = True
        if count_cold_start:
            m.cold_starts += 1
        self.meter.transition(PowerState.CTX_IDLE)
        self.arm(model_id)

    def arm(self, model_id: str) -> None:
        """(Re)arm a model's idle-eviction deadline from its policy.
        Autoscaler-held replicas never arm: the controller owns their
        lifetime (scale-in), not the per-replica policy."""
        m = self.models[model_id]
        if m.held:
            m.evict_at = math.inf
            return
        timeout = m.policy.idle_timeout_s(self.clock())
        m.evict_at = self.clock() + timeout if math.isfinite(timeout) \
            else math.inf

    def settle(self) -> None:
        """Close the current burst phase (load/serve): fall to parked or
        bare according to residency."""
        self.meter.transition(PowerState.CTX_IDLE if self._any_resident()
                              else PowerState.BARE)

    def tick(self) -> None:
        """Apply due evictions at the current sim time."""
        now = self.clock()
        for m in self.models.values():
            if m.resident and now >= m.evict_at:
                self._evict(m)

    def fail(self) -> None:
        """Device failure: all residents drop instantly (no graceful
        unload); energy state falls to bare.  Requests after this
        transparently cold-start."""
        for m in self.models.values():
            m.engine = None
            m.resident = False
            m.loading = False
            m.evict_at = math.inf
            m.pins = 0
            m.held = False
        # a failed device comes back up bare whatever it was doing
        # (including asleep: SLEEP -> BARE is the legal wake edge)
        self.meter.transition(PowerState.BARE)

    # -- request path --------------------------------------------------------
    def handle_request(self, model_id: str, *, service_s: float = 0.0,
                       work_fn: Optional[Callable[[Any], Any]] = None
                       ) -> Any:
        """Serve one request at the current sim time.

        Advances the clock by load time (if cold) + service_s, charges
        energy per state, updates the policy, and re-arms the idle
        timeout (Eq. 12/13 for Breakeven policies)."""
        self.tick()
        m = self.models[model_id]
        m.requests += 1
        m.policy.observe_arrival(self.clock())
        wait = 0.0
        if not m.resident:
            t0 = self.clock()
            self._load(m)
            wait = self.clock() - t0
            m.added_latency_s += wait
        m.latency_samples.append(wait)
        result = None
        if work_fn is not None or service_s > 0:
            self.meter.transition(PowerState.ACTIVE)
            if work_fn is not None:
                result = work_fn(m.engine)
            self.clock.advance(service_s)
        self.meter.transition(PowerState.CTX_IDLE)
        self.arm(model_id)
        return result

    def run_trace(self, model_id: str, arrivals_s: List[float], *,
                  horizon_s: float, service_s: float = 0.0) -> Dict[str, Any]:
        """Replay an arrival trace (the serving-level Table 6)."""
        for a in sorted(arrivals_s):
            target = max(a, self.clock())
            self._advance_with_evictions(target)
            self.handle_request(model_id, service_s=service_s)
        self._advance_with_evictions(horizon_s)
        m = self.models[model_id]
        return {"energy_wh": self.meter.totals(),
                "durations_s": self.meter.durations(),
                "cold_starts": m.cold_starts,
                "requests": m.requests,
                "mean_added_latency_s": (m.added_latency_s / m.requests
                                         if m.requests else 0.0),
                "parking_tax_wh": self.meter.parking_tax_wh()}

    def _advance_with_evictions(self, target: float) -> None:
        """Advance sim time, applying any eviction deadlines on the way."""
        while True:
            pending = [m.evict_at for m in self.models.values()
                       if m.resident and math.isfinite(m.evict_at)
                       and m.evict_at <= target]
            if not pending:
                break
            t_evt = min(pending)
            self.clock.advance(max(t_evt - self.clock(), 0.0))
            self.tick()
        self.clock.advance(max(target - self.clock(), 0.0))
