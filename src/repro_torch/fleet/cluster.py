"""Cluster: N per-device ModelManagers on ONE SimClock, fleet accounting.

The cluster owns the pieces the single-device serving layer cannot
express:

  * a fleet-wide model registry (a model may have replicas on any
    device; each replica gets its own policy instance and an
    architecture-specific ``LoaderSpec`` derived from checkpoint bytes,
    so t_load/T* differ per device),
  * a global eviction-aware time advance (``advance_to`` walks every
    device's armed idle timeouts in time order, so a parked model on
    device B falls to bare at the right instant even while device A is
    mid-load),
  * migration (unload on the source, split-phase load on the target --
    the physical reason consolidation saves energy is that the DVFS
    step is per-DEVICE: one context keeps the clocks up, so packing
    parked models onto fewer devices lets drained devices fall back to
    ``p_base_w``),
  * per-model arrival-rate estimation (EWMA) feeding the energy-aware
    routers and the consolidation benefit model.

Energy invariant: fleet energy is exactly the sum of the per-device
EnergyMeter totals -- there is no separate fleet meter to drift.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.coldstart import LoaderSpec, loader_from_checkpoint
from repro_torch.core.power_states import PowerState, state_power_w
from repro_torch.core.scheduler import Policy
from repro_torch.fleet.catalog import (DeviceInstance, transfer_cost_j,
                                 transfer_latency_s)
from repro_torch.serving.energy import SimClock
from repro_torch.serving.model_manager import ManagedModel, ModelManager
from repro_torch.serving.slots import WAKE_CHANNEL


def _make_policy(factory: Callable[..., Policy], loader: LoaderSpec,
                 profile, carbon_trace=None) -> Policy:
    """Instantiate a per-replica policy, feeding the replica's loader,
    device profile, and the run's carbon-intensity trace to factories
    whose signatures want them (Breakeven takes loader/profile;
    carbon.CarbonBreakeven additionally takes carbon_trace)."""
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return factory()
    kwargs = {}
    if "loader" in params:
        kwargs["loader"] = loader
    if "profile" in params:
        kwargs["profile"] = profile
    if "carbon_trace" in params:
        kwargs["carbon_trace"] = carbon_trace
    return factory(**kwargs)


class RateEstimator:
    """Time-aware EWMA of a model's inter-arrival gap (fleet-level lambda-hat)."""

    def __init__(self, halflife_s: float = 1800.0):
        self.halflife_s = halflife_s
        self.last_arrival: Optional[float] = None
        self.gap_s: Optional[float] = None

    def observe(self, t_s: float) -> None:
        if self.last_arrival is not None:
            g = max(t_s - self.last_arrival, 1e-9)
            if self.gap_s is None:
                self.gap_s = g
            else:
                alpha = 1.0 - 0.5 ** (g / self.halflife_s)
                self.gap_s += alpha * (g - self.gap_s)
        self.last_arrival = t_s

    def expected_gap_s(self, default: float = 3600.0) -> float:
        return self.gap_s if self.gap_s is not None else default

    def expected_next_arrival(self, now_s: float,
                              default_gap_s: float = 3600.0) -> float:
        if self.last_arrival is None:
            return now_s + default_gap_s
        return max(self.last_arrival + self.expected_gap_s(default_gap_s),
                   now_s)


@dataclasses.dataclass
class FleetModelSpec:
    """Cluster-level model registration (replicas instantiate from this)."""
    model_id: str
    policy_factory: Callable[[], Policy]
    loader: Optional[LoaderSpec] = None      # fixed loader on every device
    checkpoint_bytes: Optional[int] = None   # else derived per device
    vram_gb: float = 0.0
    home: Optional[str] = None               # device to prewarm on at t=0
    # per-model numbers for the calibrated service-time model; None means
    # the model derives them from checkpoint_bytes
    service: Optional[object] = None         # serving.ModelServiceProfile

    def __post_init__(self):
        if self.loader is None and self.checkpoint_bytes is None:
            raise ValueError(f"{self.model_id}: need loader or checkpoint_bytes")


class Cluster:
    def __init__(self, devices: List[DeviceInstance], *,
                 clock: Optional[SimClock] = None):
        if not devices:
            raise ValueError("empty fleet")
        self.clock = clock or SimClock()
        self.devices: Dict[str, DeviceInstance] = {
            d.instance_id: d for d in devices}
        if len(self.devices) != len(devices):
            raise ValueError("duplicate instance_id in fleet")
        self.managers: Dict[str, ModelManager] = {
            did: ModelManager(d.profile, clock=self.clock)
            for did, d in self.devices.items()}
        self.specs: Dict[str, FleetModelSpec] = {}
        self.rates: Dict[str, RateEstimator] = {}
        # per-(device, model) arrival attribution: the autoscaler's
        # scale-in test needs each REPLICA's observed demand, not just
        # the fleet-level lambda-hat the routers consume
        self.rep_rates: Dict[Tuple[str, str], RateEstimator] = {}
        self._loaders: Dict[tuple, LoaderSpec] = {}
        self.migrations = 0
        self.gates = 0          # devices put to SLEEP (power gating)
        # per-route warm-replica-count timeline: (t_s, count) appended
        # whenever snapshot_replicas observes a change; log_replicas
        # gates the appends (run_fleet detail=False -- the log is pure
        # observability, nothing reads it back into the dynamics)
        self.replica_log: Dict[str, List[Tuple[float, int]]] = {}
        self.log_replicas = True
        # attached by the fleet event loop (run_fleet): per-device
        # DeviceRuntime (serving/slots.py) + the scenario's service-time
        # model.  Empty/None when the cluster is driven directly.
        self.runtime: Dict[str, object] = {}
        self.service_model = None
        # the run's grid-intensity trace (fleet/carbon.py), bound by
        # run_fleet BEFORE any replica exists so carbon-aware policies
        # (CarbonBreakeven) receive it at construction; None when the
        # cluster is driven directly (policies fall back to energy T*)
        self.carbon_trace = None
        # per-device electricity zone + intensity trace, bound by
        # run_fleet from the scenario's device list; empty when the
        # cluster is driven directly (all devices price against
        # carbon_trace and migrations never cross a zone boundary)
        self.device_zones: Dict[str, str] = {}
        self.device_traces: Dict[str, object] = {}
        self.transfer_j = 0.0           # WAN checkpoint-transfer energy
        self.cross_zone_migrations = 0
        # spot preemption (fleet/pricing.py): devices the provider has
        # warned about or reclaimed.  Routers, the autoscaler, and the
        # consolidator all treat a revoked device like a drained gate:
        # no new placements, no migration targets.  run_fleet maintains
        # the set from the PreemptionModel's drawn events.
        self.revoked: set = set()
        self.preemptions = 0            # revocations actually applied

    # -- registry -----------------------------------------------------------
    def register_model(self, spec: FleetModelSpec) -> None:
        self.specs[spec.model_id] = spec
        self.rates[spec.model_id] = RateEstimator()
        self.replica_log[spec.model_id] = []

    def replica_rate(self, device_id: str, model_id: str) -> RateEstimator:
        key = (device_id, model_id)
        if key not in self.rep_rates:
            self.rep_rates[key] = RateEstimator()
        return self.rep_rates[key]

    def loader_for(self, model_id: str, device_id: str) -> LoaderSpec:
        """Per-(model, device) LoaderSpec: this is what makes routing
        architecture-aware -- t_load scales with the device's ingest
        bandwidth, so T* and the cold-start cost differ per SKU."""
        key = (model_id, device_id)
        if key not in self._loaders:
            spec = self.specs[model_id]
            if spec.loader is not None:
                self._loaders[key] = spec.loader
            else:
                self._loaders[key] = loader_from_checkpoint(
                    model_id, spec.checkpoint_bytes,
                    self.devices[device_id].profile)
        return self._loaders[key]

    def replica(self, device_id: str, model_id: str) -> ManagedModel:
        """Get (lazily creating) the per-device replica of a model.

        The policy factory is called with ``loader=``/``profile=`` when
        its signature accepts them, so architecture-dependent policies
        (Breakeven and friends -- pass the CLASS as the factory) get
        each replica's own T*."""
        mm = self.managers[device_id]
        if model_id not in mm.models:
            spec = self.specs[model_id]
            loader = self.loader_for(model_id, device_id)
            policy = _make_policy(spec.policy_factory, loader,
                                  self.devices[device_id].profile,
                                  self.carbon_trace)
            mm.register(model_id, policy=policy, loader=loader,
                        vram_gb=spec.vram_gb)
        return mm.models[model_id]

    # -- state queries -------------------------------------------------------
    def locations(self, model_id: str, *, include_loading: bool = True
                  ) -> List[str]:
        out = []
        for did, mm in self.managers.items():
            m = mm.models.get(model_id)
            if m is not None and (m.resident or
                                  (include_loading and m.loading)):
                out.append(did)
        return sorted(out)

    def context_on(self, device_id: str) -> bool:
        mm = self.managers[device_id]
        return any(m.resident or m.loading for m in mm.models.values())

    def occupancy(self, device_id: str) -> int:
        mm = self.managers[device_id]
        return sum(1 for m in mm.models.values() if m.resident or m.loading)

    def free_slots(self, device_id: str) -> int:
        return self.devices[device_id].sku.slots - self.occupancy(device_id)

    def free_vram_gb(self, device_id: str) -> float:
        mm = self.managers[device_id]
        return self.devices[device_id].sku.vram_gb - mm.vram_used_gb()

    def fits(self, device_id: str, model_id: str) -> bool:
        return (self.free_slots(device_id) >= 1
                and self.free_vram_gb(device_id)
                >= self.specs[model_id].vram_gb)

    # -- concurrency state (fed by the attached DeviceRuntimes) --------------
    def attach_runtime(self, runtime: Dict[str, object],
                       service_model=None) -> None:
        """Register the fleet event loop's per-device runtimes so routers
        (queue depth, slot occupancy) and the power composer can see
        in-flight work."""
        self.runtime = runtime
        if service_model is not None:
            self.service_model = service_model

    def busy_slots(self, device_id: str,
                   model_id: Optional[str] = None) -> int:
        rt = self.runtime.get(device_id)
        return rt.busy_slots(model_id) if rt is not None else 0

    def waiting_requests(self, device_id: str,
                         model_id: Optional[str] = None) -> int:
        rt = self.runtime.get(device_id)
        return rt.waiting_count(model_id) if rt is not None else 0

    def decode_slots(self, device_id: str) -> int:
        rt = self.runtime.get(device_id)
        return rt.max_batch if rt is not None else 1

    def queued_load_demand(self, device_id: str) -> Tuple[int, float]:
        """(slots, vram_gb) that loads still QUEUED on this device's
        loader channel will consume when they start.  Queued-not-started
        loads are invisible to occupancy/free_vram_gb (only resident or
        loading replicas count), so capacity planners that look across
        ticks must add this on top of ``fits``."""
        rt = self.runtime.get(device_id)
        if rt is None:
            return 0, 0.0
        slots, vram = 0, 0.0
        seen = set()
        for item in rt.load_q:
            mid = item[-1]
            if mid in seen:               # load + queued migration race:
                continue                  # only one of them will land
            seen.add(mid)
            m = self.managers[device_id].models.get(mid)
            if m is not None and (m.resident or m.loading):
                continue                  # already counted by occupancy
            slots += 1
            vram += self.specs[mid].vram_gb
        return slots, vram

    def pending_scaleouts(self, model_id: str) -> List[str]:
        """Devices where this model's (re)load or migration is in flight
        or queued on the loader channel but the replica is not resident
        yet -- capacity that is COMING UP (the SLO router and the
        autoscaler both count it, so neither double-provisions a route
        mid-scale-out).  Queued migrations never enter ``load_queued``,
        so the channel queue itself is scanned too."""
        out = []
        for did, rt in self.runtime.items():
            if rt is None:
                continue
            m = self.managers[did].models.get(model_id)
            if m is not None and m.resident:
                continue
            if (rt.loading == model_id or model_id in rt.load_queued
                    or any(item[-1] == model_id for item in rt.load_q)):
                out.append(did)
        return sorted(out)

    def snapshot_replicas(self, t_s: float) -> None:
        """Append (t, warm-replica count) per route when the count moved.
        The fleet event loop samples after every event, and advance_to
        samples at each eviction instant it applies, so scale-out
        landings AND timeout evictions are timestamped exactly."""
        if not self.log_replicas:
            return
        for mid in self.specs:
            n = len(self.locations(mid, include_loading=False))
            log = self.replica_log[mid]
            if not log or log[-1][1] != n:
                log.append((t_s, n))

    def load_residual_s(self, device_id: str, now_s: float) -> float:
        """Remaining seconds of the in-flight load (0 when idle)."""
        rt = self.runtime.get(device_id)
        if rt is None or rt.loading is None:
            return 0.0
        return max(rt.loading_until - now_s, 0.0)

    def load_backlog_s(self, device_id: str, now_s: float, *,
                       exclude_model: Optional[str] = None) -> float:
        """Seconds of loader-channel work ahead of a load enqueued now:
        residual of the in-flight load + queued (re)loads/migrations.
        ``exclude_model`` skips that model's own queued load (a caller
        estimating ITS wait would otherwise count it twice)."""
        rt = self.runtime.get(device_id)
        if rt is None:
            return 0.0
        s = self.load_residual_s(device_id, now_s)
        for item in rt.load_q:
            if item[-1] != exclude_model:
                s += self.loader_for(item[-1], device_id).t_load_s
        return s

    def sync_power(self, device_id: str, *,
                   service_util: float = 0.6) -> None:
        """Recompose the device's metered power from its concurrent phase
        state (the additive decomposition that makes overlap meterable):

            P = (p_load if a load is in flight else P_idle(ctx))
                + busy_slots * (P_active - P_ctx)

        With one phase at a time this reduces exactly to the serialized
        accounting (flat p_load during loads, active_power_w(0.6) during
        service), preserving the single-device equivalence anchor; with
        overlap, each busy decode slot adds its above-context increment
        on top of whichever base phase is running.

        Gated devices are the state machine's business, not the
        composer's: a SLEEPING device is left asleep (nothing can be in
        flight there -- illegal transitions would have raised earlier),
        and an in-flight wake ramp keeps its override so a racing event
        cannot settle the ramp's watts away mid-wake."""
        mm = self.managers[device_id]
        prof = self.devices[device_id].profile
        if mm.meter.state in (PowerState.SLEEP, PowerState.OFF):
            # gated or revoked: the state machine owns these (wake ramp /
            # preempt_restore); settling here would silently power the
            # device back up
            return
        rt = self.runtime.get(device_id)
        if rt is not None and rt.loading == WAKE_CHANNEL:
            mm.meter.transition(
                PowerState.BARE,
                power_override_w=mm.meter.power_override_w)
            return
        loading = next((m for m in mm.models.values() if m.loading), None)
        busy = self.busy_slots(device_id)
        if busy > 0:
            base = loading.loader.p_load_w if loading is not None \
                else prof.idle_power_w(context_active=True)
            p = base + busy * (prof.active_power_w(service_util)
                               - prof.p_ctx_w)
            mm.meter.transition(PowerState.ACTIVE, power_override_w=p)
        elif loading is not None:
            mm.meter.transition(PowerState.LOADING,
                                power_override_w=loading.loader.p_load_w)
        else:
            mm.settle()

    def idle_power_w(self) -> float:
        """Instantaneous fleet idle power from power state (Eq. 1 summed
        over devices, with gated devices at their sleep floor;
        loading/active bursts excluded by design -- this is the
        steady-state quantity consolidation + gating optimize)."""
        total = 0.0
        for did, dev in self.devices.items():
            state = self.power_state(did)
            if state is PowerState.OFF:
                continue                  # reclaimed: draws nothing
            if state is PowerState.SLEEP:
                total += dev.profile.p_sleep_w
            else:
                total += dev.profile.idle_power_w(self.context_on(did))
        return total

    # -- power gating (sleep/wake; core/power_states.py) ---------------------
    def power_state(self, device_id: str) -> PowerState:
        """The device's current power state (its meter's machine)."""
        return self.managers[device_id].meter.state

    def gate_device(self, device_id: str) -> bool:
        """Put a fully drained device to SLEEP now, if it is safe to:
        meter settled at BARE (no residents, no burst in flight) and no
        runtime work queued on its loader channel or decode slots.
        Returns whether the device actually gated."""
        mm = self.managers[device_id]
        if mm.meter.state is not PowerState.BARE:
            return False
        if self.occupancy(device_id) > 0:
            return False
        rt = self.runtime.get(device_id)
        if rt is not None and rt.busy:
            return False
        mm.meter.gate()
        self.gates += 1
        return True

    def start_wake(self, device_id: str) -> float:
        """Begin the SLEEP -> BARE wake ramp; returns its duration.  The
        fleet event loop serializes it on the device's loader channel
        (``WAKE_CHANNEL``) so loads start only once the device is up."""
        return self.managers[device_id].meter.begin_wake()

    def finish_wake(self, device_id: str) -> None:
        self.managers[device_id].meter.finish_wake()

    def bare_idle_s(self, device_id: str, now_s: float) -> float:
        """How long the device has been settled at BARE (0 when in any
        other state) -- the realized wait the gating ski rental tests
        against ``gate_breakeven_s``."""
        meter = self.managers[device_id].meter
        if meter.state is not PowerState.BARE:
            return 0.0
        return max(now_s - meter.state_since_s(), 0.0)

    # -- time ---------------------------------------------------------------
    def advance_to(self, target_s: float) -> None:
        """Advance the shared clock, applying every device's armed idle
        timeouts in time order on the way.

        A deadline landing EXACTLY on the target stays armed: the
        single-device simulator keeps a model warm when the idle gap
        equals the timeout (`stay < gap` is strict), and the arriving
        event at `target_s` re-arms or supersedes it."""
        while True:
            pending = [m.evict_at
                       for mm in self.managers.values()
                       for m in mm.models.values()
                       if m.resident and math.isfinite(m.evict_at)
                       and m.evict_at < target_s]
            if not pending:
                break
            t_evt = min(pending)
            self.clock.advance(max(t_evt - self.clock(), 0.0))
            for mm in self.managers.values():
                mm.tick()
            self.snapshot_replicas(t_evt)
        self.clock.advance(max(target_s - self.clock(), 0.0))

    # -- request-path primitives (the fleet event loop sequences these) -----
    def observe_arrival(self, model_id: str, device_id: str, t_s: float
                        ) -> None:
        """Feed one arrival to the fleet rate estimator AND the routed
        replica's policy (at the true arrival time, as the single-device
        simulator does)."""
        self.rates[model_id].observe(t_s)
        self.replica_rate(device_id, model_id).observe(t_s)
        self.replica(device_id, model_id).policy.observe_arrival(t_s)

    def start_load(self, device_id: str, model_id: str) -> float:
        """Begin a split-phase load; returns its duration.  Evicts idle
        parked models first if the device is over capacity."""
        self.replica(device_id, model_id)
        self.make_room(device_id, model_id)
        return self.managers[device_id].begin_load(model_id)

    def finish_load(self, device_id: str, model_id: str) -> None:
        self.managers[device_id].finish_load(model_id)
        self.managers[device_id].arm(model_id)

    def begin_serve(self, device_id: str, model_id: str, arrival_s: float,
                    *, service_s: float = 0.0) -> None:
        m = self.replica(device_id, model_id)
        m.requests += 1
        wait = max(self.clock() - arrival_s, 0.0)
        m.added_latency_s += wait
        m.latency_samples.append(wait)
        m.evict_at = math.inf          # never evict mid-service
        if service_s > 0 and not self.runtime:
            # legacy blocking path (no concurrent runtime attached): the
            # caller owns advancing the clock through the service window
            self.managers[device_id].meter.transition(PowerState.ACTIVE)

    def end_serve(self, device_id: str, model_id: str) -> None:
        mm = self.managers[device_id]
        mm.settle()
        m = mm.models[model_id]
        m.pins = max(0, m.pins - 1)
        if m.resident:
            if m.pins > 0:
                m.evict_at = math.inf     # more queued demand: stay pinned
            else:
                mm.arm(model_id)

    def cancel_serve(self, device_id: str, model_id: str,
                     wait_s: float) -> None:
        """Reverse ``begin_serve``'s bookkeeping for one in-flight
        request a preemption orphaned: the request was NOT served here,
        so its count and latency sample move with it to wherever the
        re-dispatch lands (conservation: served == arrivals, each
        counted exactly once).  ``latency_samples.remove`` drops the
        first equal value -- samples are a multiset, so any equal
        entry is the same observation.  Pins are left alone: the caller
        follows with ``force_off``, whose ``fail()`` zeroes them."""
        m = self.managers[device_id].models[model_id]
        m.requests -= 1
        m.added_latency_s -= wait_s
        m.latency_samples.remove(wait_s)

    # -- spot preemption (fleet/pricing.py draws; run_fleet replays) ---------
    def force_off(self, device_id: str) -> None:
        """Provider reclaims the device NOW: every resident/loading
        replica is dropped instantly (``ModelManager.fail`` -- no
        orderly unload, the weights are just gone) and the meter lands
        at OFF (0 W; OFF seconds are unbilled for usage tiers).  The
        caller has already collected orphaned requests via
        ``cancel_serve`` -- fail() zeroes pins, so cancel must run
        first."""
        mm = self.managers[device_id]
        mm.fail()
        mm.meter.transition(PowerState.OFF)
        self.revoked.add(device_id)
        self.preemptions += 1

    def restore_device(self, device_id: str) -> None:
        """The outage ends: the device returns, cold and empty, at
        BARE, and leaves the revoked set so placement can use it
        again."""
        self.managers[device_id].meter.transition(PowerState.BARE)
        self.revoked.discard(device_id)

    def preview_timeout_s(self, model_id: str, device_id: str,
                          now_s: float) -> float:
        """Idle timeout a replica of this model would arm on this device,
        WITHOUT registering it (the consolidation planner speculates over
        candidate targets and must not mutate managers)."""
        mm = self.managers[device_id]
        m = mm.models.get(model_id)
        if m is not None:
            return m.policy.idle_timeout_s(now_s)
        spec = self.specs[model_id]
        policy = _make_policy(spec.policy_factory,
                              self.loader_for(model_id, device_id),
                              self.devices[device_id].profile,
                              self.carbon_trace)
        return policy.idle_timeout_s(now_s)

    def make_room(self, device_id: str, model_id: str) -> None:
        """Best-effort capacity enforcement: unload parked-idle models
        (soonest-to-evict first) until the new model fits.  In-flight
        (loading) models are never touched."""
        mm = self.managers[device_id]
        need_gb = self.specs[model_id].vram_gb
        sku = self.devices[device_id].sku

        def over() -> bool:
            used = mm.vram_used_gb()
            occ = self.occupancy(device_id)
            return (used + need_gb > sku.vram_gb or occ + 1 > sku.slots)

        victims = sorted(
            (m for m in mm.models.values()
             if m.resident and m.model_id != model_id and m.pins == 0),
            key=lambda m: m.evict_at)
        for v in victims:
            if not over():
                break
            mm.unload(v.model_id)

    # -- replica scale-in (autoscaler) --------------------------------------
    def scale_in(self, device_id: str, model_id: str) -> bool:
        """Retire one warm replica NOW, if it is safe to: resident, not
        mid-load, no pinned/queued demand, no busy decode slots.  Returns
        whether the replica was actually unloaded.  The device's meter
        re-settles, so a fully drained device falls back to bare."""
        m = self.managers[device_id].models.get(model_id)
        if m is None or not m.resident or m.loading or m.pins > 0:
            return False
        if (self.busy_slots(device_id, model_id) > 0
                or self.waiting_requests(device_id, model_id) > 0):
            return False
        self.managers[device_id].unload(model_id)
        self.sync_power(device_id)
        return True

    # -- migration ----------------------------------------------------------
    def device_trace(self, device_id: str):
        """The intensity trace this device's joules are priced against:
        its zone's trace when run_fleet bound one, else the scenario
        trace (so single-zone runs stay on the exact same object)."""
        return self.device_traces.get(device_id) or self.carbon_trace

    def migration_transfer(self, model_id: str, src_id: str, dst_id: str
                           ) -> Tuple[float, float]:
        """(extra latency s, WAN energy J) of shipping model_id's
        checkpoint from src's zone to dst's zone.  (0, 0) when the move
        stays inside one zone, when zones are unbound, or when the spec
        has no checkpoint size to ship."""
        za = self.device_zones.get(src_id)
        zb = self.device_zones.get(dst_id)
        if za is None or zb is None or za == zb:
            return 0.0, 0.0
        ckpt = self.specs[model_id].checkpoint_bytes or 0
        gb = ckpt / 1024 ** 3
        return (transfer_latency_s(gb, za, zb), transfer_cost_j(gb, za, zb))

    def start_migration(self, model_id: str, src_id: str, dst_id: str
                        ) -> float:
        """Unload from src, begin the (split-phase) load on dst; returns
        the load duration.  The caller owns scheduling finish_load.
        Cross-zone moves ship the checkpoint over the WAN first: the
        returned duration stretches by the transfer latency (so the
        added cold-start delay lands in the existing p99 accounting)
        and the transfer energy accrues to transfer_j."""
        src = self.managers[src_id]
        exported_engine = None
        m_src = src.models.get(model_id)
        if m_src is not None and m_src.resident:
            exported_engine = m_src.engine
        src.unload(model_id)
        dst_m = self.replica(dst_id, model_id)
        if dst_m.load_fn is None and exported_engine is not None:
            dst_m.engine = exported_engine
        self.migrations += 1
        xfer_s, xfer_j = self.migration_transfer(model_id, src_id, dst_id)
        if xfer_s > 0.0 or xfer_j > 0.0:
            self.cross_zone_migrations += 1
            self.transfer_j += xfer_j
        return self.start_load(dst_id, model_id) + xfer_s

    # -- reporting ----------------------------------------------------------
    def device_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-device energy (Wh by meter state incl. 'total'); flushes
        meters to 'now'."""
        return {did: mm.meter.totals()
                for did, mm in self.managers.items()}
