"""Event-driven multi-model / multi-device parking-tax simulation.

Lifts ``core/simulator.py`` (one model, one device) to cluster scale:
M models' arrival traces are routed across N heterogeneous devices by a
``Router``; per-replica eviction policies arm idle timeouts; an optional
``Consolidator`` periodically packs parked models onto fewer devices.
Every joule is metered by the per-device ``EnergyMeter`` inside each
``ModelManager`` -- fleet energy is the sum of device meters by
construction.

Faithfulness anchor: with 1 device x 1 model, a stateless policy, and
the same trace, ``run_fleet`` reproduces ``simulator.simulate`` energy
to float precision (tested to 1e-6 Wh): the same power constants are
integrated over the same instants (warm idle at P_ctx, evicted at
P_base, loads at P_load, start-warm counts one cold start).

Events (heap, stable order: phase completions before consolidation
before arrivals at equal times):
  * arrival    -- route, then serve / queue / trigger a load
  * load_done  -- land a split-phase (re)load, drain that model's wait
                  queue into decode slots, pump the loader channel
  * serve_done -- release the decode slot, admit the next waiter
  * consolidate-- run the packing pass, enqueue migrations

Concurrency model (serving/slots.py DeviceRuntime): each device has ONE
serialized loader channel (weight ingest is PCIe/storage-bound) and,
per resident model, ``max_batch`` decode slots -- so loads overlap
serving and up to ``max_batch`` requests per model decode concurrently.
Service time per request comes from the scenario's ``ServiceTimeModel``
(serving/service_model.py), frozen at admission occupancy.  Power under
overlap composes additively (Cluster.sync_power): the idle/loading base
plus one above-context active increment per busy slot -- which reduces
exactly to the old serialized accounting when phases never overlap, so
the single-device equivalence anchor below still holds.  Queued
requests for a model that is mid-load are served the instant the load
completes, which is exactly the single-device simulator's batching
rule.

Carbon accounting integrates by TRACE, not scalar: every device meter
records its power timeline, and ``FleetResult.carbon_kg`` is the
integral of that power against the scenario's grid-intensity trace
(fleet/carbon.py).  With the default flat trace this reproduces the old
``energy_kwh * gwp`` scalar to 1e-9 kg (tested); with a diurnal trace
the SAME joules cost different kgCO2e depending on WHEN they are drawn,
which is what the carbon-aware router/consolidator/autoscaler modes
optimize against.

Power gating (core/power_states.py): with a ``Consolidator`` in
``gate_drained_devices`` mode, fully drained devices fall below
``p_base_w`` to SLEEP once their bare idle clears the wake-energy
breakeven; a load routed to a gated device first runs the SLEEP -> BARE
wake ramp on the device's loader channel (``WAKE_CHANNEL``), so wake
latency and wake energy are metered like any other phase.
``FleetResult`` reports per-state Wh/seconds and ``gated_wh_saved`` --
the first mechanism that cuts below the bare-idle floor.

The clairvoyant lower bound reported alongside is the cluster analogue
of ``scheduler.Clairvoyant``: per model, offline per-gap ski rental
using the fleet's BEST constants (min DVFS step across devices, min
above-bare reload energy).  ``lb_nongated_wh`` takes the max over
models (valid even when co-parked models share one context -- any
feasible schedule restricted to one model is a feasible single-model
schedule); ``cv_per_model_wh`` sums over models (the tighter reference
when contexts are not shared).  Both floors carry a per-device
``p_base`` term that assumes devices never SLEEP, so they bound only
NON-GATED runs: a power-gated run (Consolidator
``gate_drained_devices``) legitimately lands below them -- that is the
point of gating, and the reason the field is scoped (and named)
non-gated rather than universal.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.coldstart import loader_from_checkpoint
from repro_torch.core.power_states import PowerState
from repro_torch.fleet.autoscaler import ReplicaAutoscaler, ScaleOut
from repro_torch.fleet.carbon import (CarbonTrace, carbon_timeline_kg,
                                carbon_timeline_multi_kg,
                                resolve_zone_trace)
from repro_torch.fleet.catalog import (DeviceInstance, build_fleet, carbon_kg,
                                 energy_cost_usd, fleet_price_usd, get_mix)
from repro_torch.fleet.cluster import Cluster, FleetModelSpec
from repro_torch.fleet.pricing import (PreemptionModel, device_tier_map,
                                 price_fleet, tier_billed_seconds)
from repro_torch.fleet.router import Consolidator, Router, get_router
from repro_torch.serving.service_model import ConstantServiceTime, ServiceTimeModel
from repro_torch.serving.slots import DeviceRuntime, WAKE_CHANNEL

DAY = 24 * 3600.0

# event phases at equal timestamps:
# completions < autoscale < consolidation < arrivals < faults
# (faults LAST so a preemption landing exactly at an arrival orphans
# that request like any other in-flight work; phases 0-3 are unchanged,
# keeping zero-preemption runs event-order identical to before)
_P_DONE, _P_AUTO, _P_CONS, _P_ARR, _P_FAULT = 0, 1, 2, 3, 4


@dataclasses.dataclass
class FleetModel:
    """One workload: a cluster-level model spec + its arrival trace."""
    spec: FleetModelSpec
    arrivals_s: Sequence[float]


@dataclasses.dataclass
class FleetScenario:
    devices: List[DeviceInstance]
    models: List[FleetModel]
    router: Union[Router, str] = "warm-first"
    horizon_s: float = DAY
    service_s: float = 0.0                   # legacy constant service time
    consolidator: Optional[Consolidator] = None
    autoscaler: Optional[ReplicaAutoscaler] = None
    zone: str = "USA"
    price_tier: str = "on_demand"
    # concurrency knobs: decode slots per resident model, and the
    # service-time model (None -> ConstantServiceTime(service_s), which
    # with the default service_s=0 reproduces the paper's
    # service-energy-held-constant convention)
    max_batch: int = 4
    service_model: Optional[ServiceTimeModel] = None
    # time-varying grid intensity (fleet/carbon.py):
    #   None          -> flat at the zone's mean (EXACTLY the scalar
    #                    kgCO2e accounting; the equivalence anchor)
    #   "zone"        -> the zone's preset diurnal shape
    #   a shape name  -> that shape at the zone's mean ("solar-duck", ..)
    #   a CarbonTrace -> used as-is
    carbon_trace: Union[CarbonTrace, str, None] = None
    # spot preemption (fleet/pricing.py): None -> no faults (every
    # existing scenario replays bit-exactly); a PreemptionModel draws
    # seeded revocations for the fleet's spot-tier devices, which the
    # event loop replays as warn/off/restore faults
    preemptions: Optional[PreemptionModel] = None

    def resolved_service_model(self) -> ServiceTimeModel:
        return self.service_model or ConstantServiceTime(self.service_s)

    def resolved_carbon_trace(self) -> CarbonTrace:
        """The intensity curve this run integrates emissions against
        (see ``carbon_trace``); flat-at-mean when unset.  Delegates to
        ``carbon.resolve_zone_trace`` -- the one owner of the
        zone->(trace, mean) mapping -- so scenario-level and per-device
        zone resolution can never disagree."""
        return resolve_zone_trace(self.zone, self.carbon_trace)

    def device_zones(self) -> Dict[str, str]:
        """instance_id -> electricity zone: the device's own pinned zone
        (``DeviceInstance.zone``) or the scenario zone, canonical."""
        home = get_mix(self.zone).zone
        return {d.instance_id: (d.zone or home) for d in self.devices}

    def device_tiers(self) -> Dict[str, str]:
        """instance_id -> purchase tier: the device's own pinned tier
        (``DeviceInstance.tier``) or the scenario ``price_tier`` --
        the tier shape of ``device_zones``."""
        return device_tier_map(self.devices, self.price_tier)

    def device_carbon_traces(self, resolved: Optional[CarbonTrace] = None
                             ) -> Dict[str, CarbonTrace]:
        """instance_id -> the intensity curve THAT device's joules price
        against.  Devices in the scenario zone (or with no pinned zone)
        get the scenario's resolved trace OBJECT -- the same floats in
        the same order, so uniform-zone fleets reproduce the scenario-
        zone run bit-exactly; devices pinned elsewhere resolve the same
        ``carbon_trace`` spec against their own zone through the shared
        resolver."""
        base = resolved if resolved is not None \
            else self.resolved_carbon_trace()
        home = get_mix(self.zone).zone
        cache: Dict[str, CarbonTrace] = {home: base}
        out: Dict[str, CarbonTrace] = {}
        for d in self.devices:
            z = d.zone or home
            if z not in cache:
                cache[z] = resolve_zone_trace(z, self.carbon_trace,
                                              scenario_zone=home)
            out[d.instance_id] = cache[z]
        return out


@dataclasses.dataclass
class DeviceReport:
    instance_id: str
    sku: str
    energy_wh: Dict[str, float]          # by power state + "total"
    parking_tax_wh: float
    cold_starts: int
    requests: int
    resident: List[str]                  # models resident at horizon end
    meter_state: str                     # power state at horizon end
    carbon_kg: float = 0.0               # trace-integrated device emissions
    zone: str = ""                       # electricity zone the device sits in
    # per-power-state seconds (same keys as energy_wh, minus "total")
    durations_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    wakes: int = 0                       # SLEEP -> BARE ramps metered
    # Wh below what bare idle would have cost over the gated windows
    gated_wh_saved: float = 0.0

    @property
    def total_wh(self) -> float:
        return self.energy_wh["total"]


@dataclasses.dataclass
class FleetResult:
    router: str
    horizon_s: float
    devices: List[DeviceReport]
    energy_wh: float
    parking_tax_wh: float
    cold_starts: int
    requests: int
    added_latency_s_total: float
    migrations: int
    # clairvoyant floors for NON-GATED runs (see clairvoyant_bound): the
    # p_base term assumes devices never sleep, so a gated run can land
    # below these -- compare against them only when no gating ran
    lb_nongated_wh: float
    cv_per_model_wh: float
    infra_usd: float
    energy_usd: float
    carbon_kg: float
    # per-request added latency (queue wait + cold start), sorted
    latencies_s: Sequence[float] = ()
    # per-route warm-replica-count timeline: model_id -> [(t_s, count)],
    # one entry per change (autoscaler study instrument)
    replica_timeline: Dict[str, List[Tuple[float, int]]] = \
        dataclasses.field(default_factory=dict)
    scale_outs: int = 0
    scale_ins: int = 0
    # carbon accounting (fleet/carbon.py): `carbon_kg` above is the
    # TRACE-INTEGRAL of the metered power over the run's intensity
    # curve; `carbon_kg_flat` is the legacy scalar (energy x zone mean),
    # equal to carbon_kg under a flat trace (pinned to 1e-9 kg)
    carbon_kg_flat: float = 0.0
    carbon_trace_name: str = "flat"
    # cumulative kgCO2e at (hourly) bin boundaries: [(t_s, kg_so_far)]
    carbon_timeline: Sequence[Tuple[float, float]] = ()
    # fleet-wide metered power segments (t0_s, t1_s, watts) -- carbon is
    # a POST-HOC integral over these, so one run can be re-priced under
    # any trace/zone without re-simulating (see carbon_with)
    power_timeline: Sequence[Tuple[float, float, float]] = ()
    # power-state machine breakdowns (core/power_states.py): fleet-wide
    # Wh and seconds per state (summed over devices; keys are the state
    # wire names -- "sleep"/"bare"/"parked"/"loading"/"active")
    state_energy_wh: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    state_durations_s: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    # power gating: devices put to SLEEP, wake ramps metered, and the Wh
    # the gated windows saved vs idling bare through them -- the first
    # mechanism that cuts BELOW the p_base floor
    gates: int = 0
    wakes: int = 0
    gated_wh_saved: float = 0.0
    # run_mega backend instrumentation: wall-clock seconds spent in the
    # bulk-scan phases ("biggap_s" / "billing_s" / "energy_s" /
    # "carbon_s" and their sum "bulk_scan_s"); None for event-loop runs
    phase_timings: Optional[Dict[str, float]] = None
    # per-zone decompositions of the global totals (one entry per zone
    # present in the fleet; single-zone runs get a one-key dict whose
    # value fsum-reduces to the global total)
    zone_energy_wh: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    zone_carbon_kg: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    # cross-zone checkpoint-transfer accounting (follow-the-sun
    # migrations): NETWORK energy, reported alongside -- not inside --
    # energy_wh, which stays the device-meter integral
    transfer_wh: float = 0.0
    cross_zone_migrations: int = 0
    # dollar accounting (fleet/pricing.py): cost_usd = gpu_hours_usd +
    # energy_usd exactly.  gpu_hours_usd bills each device's metered
    # power-state seconds at its tier rate (SLEEP/OFF unbilled except
    # reserved) -- unlike the legacy infra_usd flat quote above, which
    # stays as the hold-the-whole-fleet-on-demand reference.  The
    # per-device / per-zone dicts fsum back to the totals (1e-12 rel,
    # property-tested) and match across all three engines to 1e-9 rel.
    cost_usd: float = 0.0
    gpu_hours_usd: float = 0.0
    device_gpu_usd: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_cost_usd: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    zone_cost_usd: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_tiers: Dict[str, str] = dataclasses.field(default_factory=dict)
    # spot preemption: revocations applied and requests orphaned by them
    # that were re-queued elsewhere (conservation: none are dropped)
    preemptions: int = 0
    requeued_requests: int = 0
    # tier -> billed seconds across the devices billed under it
    # (pricing.tier_billed_seconds; the torch backend's fused metering
    # kernel emits it in-pass) -- engines agree to <=1e-9 rel
    tier_billed_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def peak_replicas(self, model_id: Optional[str] = None) -> int:
        """Max concurrent warm replicas over the horizon (one route, or
        the max across routes)."""
        logs = ([self.replica_timeline.get(model_id, [])] if model_id
                else list(self.replica_timeline.values()))
        return max((n for log in logs for _, n in log), default=0)

    @property
    def mean_added_latency_s(self) -> float:
        return (self.added_latency_s_total / self.requests
                if self.requests else 0.0)

    def _latency_pct(self, q: float) -> float:
        arr = np.asarray(self.latencies_s, dtype=float)
        return float(np.percentile(arr, q)) if arr.size else 0.0

    @property
    def p50_added_latency_s(self) -> float:
        return self._latency_pct(50.0)

    @property
    def p99_added_latency_s(self) -> float:
        return self._latency_pct(99.0)

    @property
    def requests_per_s(self) -> float:
        return self.requests / self.horizon_s if self.horizon_s > 0 else 0.0

    def savings_vs(self, baseline: "FleetResult") -> float:
        """Fractional energy saving vs a baseline run; 0.0 against a
        degenerate zero-energy baseline (instead of inf/ZeroDivision)."""
        if baseline.energy_wh <= 0.0:
            return 0.0
        return 1.0 - self.energy_wh / baseline.energy_wh

    def carbon_savings_vs(self, baseline: "FleetResult") -> float:
        """Fractional kgCO2e saving vs a baseline run (same guard as
        ``savings_vs``) -- the per-policy carbon delta the bench rows
        report."""
        if baseline.carbon_kg <= 0.0:
            return 0.0
        return 1.0 - self.carbon_kg / baseline.carbon_kg

    def carbon_with(self, trace: CarbonTrace) -> float:
        """Re-price this run's emissions under a different intensity
        trace WITHOUT re-simulating: carbon is an integral over the
        recorded ``power_timeline``, which does not depend on the trace
        (the dynamics only change when a carbon-aware component was
        steering -- this prices the same schedule on another grid)."""
        return trace.carbon_for_segments(self.power_timeline)


def run_fleet(scenario: FleetScenario, *, compute_bound: bool = True,
              detail: bool = True) -> FleetResult:
    """Event-loop fleet simulation (the full-scope reference engine).

    ``compute_bound=False`` skips the clairvoyant lower bound (an extra
    whole-fleet analysis pass; ``lb_nongated_wh``/``cv_per_model_wh``
    report 0.0) and ``detail=False`` skips the replica timeline log and
    the hourly carbon timeline -- pure post-processing that no other
    ``FleetResult`` field reads.  The planner's worker pool uses both:
    the PlanPoint objectives (cost/energy/carbon/p99 and their
    decompositions) are bit-identical either way.
    """
    sc = scenario
    router = get_router(sc.router) if isinstance(sc.router, str) else sc.router
    svc = sc.resolved_service_model()
    trace = sc.resolved_carbon_trace()
    # carbon-aware components see the run's intensity curve; everything
    # else ignores it (a flat trace makes the aware components behave
    # exactly like their energy-only counterparts)
    for comp in (router, sc.consolidator, sc.autoscaler):
        if comp is not None and hasattr(comp, "set_carbon_trace"):
            comp.set_carbon_trace(trace)
    if sc.autoscaler is not None:
        sc.autoscaler.reset()
    cluster = Cluster(sc.devices)
    cluster.log_replicas = detail
    cluster.carbon_trace = trace      # before any replica/policy exists
    # per-device zone plumbing: each device prices its joules (and the
    # zone-aware router/consolidator price their candidates) against the
    # device's OWN zone trace; single-zone fleets bind the scenario
    # trace object everywhere, keeping them bit-exact
    zones = sc.device_zones()
    dev_traces = sc.device_carbon_traces(trace)
    multi_zone = len(set(zones.values())) > 1
    cluster.device_zones = zones
    cluster.device_traces = dev_traces
    for fm in sc.models:
        cluster.register_model(fm.spec)
    for fm in sc.models:                      # warm starts (Table-6 style)
        if fm.spec.home is None:
            continue
        mid = fm.spec.model_id
        home = fm.spec.home
        # prewarm respects capacity: an over-committed home falls back to
        # the least-loaded device that fits, else the model starts cold
        # (keeps the warm-everywhere baseline physically feasible)
        if not cluster.fits(home, mid):
            fitting = [d for d in sorted(cluster.devices)
                       if cluster.fits(d, mid)]
            if not fitting:
                continue
            home = min(fitting, key=lambda d: (cluster.occupancy(d),
                                               -cluster.free_vram_gb(d), d))
        cluster.replica(home, mid)
        cluster.managers[home].prewarm(mid)

    heap: List[Tuple[float, int, int, str, tuple]] = []
    seq = itertools.count()

    def push(t: float, phase: int, kind: str, data: tuple) -> None:
        heapq.heappush(heap, (t, phase, next(seq), kind, data))

    for fm in sc.models:
        for a in fm.arrivals_s:
            a = float(a)
            if 0.0 <= a < sc.horizon_s:
                push(a, _P_ARR, "arrival", (fm.spec.model_id,))
    if sc.consolidator is not None and sc.consolidator.period_s < sc.horizon_s:
        push(sc.consolidator.period_s, _P_CONS, "consolidate", ())
    if sc.autoscaler is not None and sc.autoscaler.tick_s < sc.horizon_s:
        push(sc.autoscaler.tick_s, _P_AUTO, "autoscale", ())

    # spot preemption: the model's draw is pure data, replayed here as
    # warn/off/restore faults.  No preemption model (or a draw with no
    # events) pushes nothing -- the heap, and the run, are bit-identical
    # to before the fault path existed.
    tiers = sc.device_tiers()
    revocations = (sc.preemptions.draw(sc.devices, tiers, sc.horizon_s)
                   if sc.preemptions is not None else [])
    for rv in revocations:
        if rv.warn_at_s < rv.off_at_s:
            push(rv.warn_at_s, _P_FAULT, "preempt_warn", (rv.device_id,))
        push(rv.off_at_s, _P_FAULT, "preempt_off", (rv.device_id,))
        if math.isfinite(rv.restore_at_s) and rv.restore_at_s < sc.horizon_s:
            push(rv.restore_at_s, _P_FAULT, "preempt_restore",
                 (rv.device_id,))

    rt = {did: DeviceRuntime(sc.max_batch) for did in cluster.devices}
    cluster.attach_runtime(rt, svc)
    cluster.snapshot_replicas(0.0)            # timeline origin (prewarms)

    # preemption bookkeeping: each device's fault epoch (completion
    # events carry the epoch they were scheduled under; a preempt_off
    # bumps it, orphaning every outstanding serve/load/wake completion),
    # and the in-flight request registry the OFF handler collects for
    # re-dispatch -- (model, slot) -> (arrival time, charged wait)
    epoch = {did: 0 for did in cluster.devices}
    inflight: Dict[str, Dict[Tuple[str, int], Tuple[float, float]]] = \
        {did: {} for did in cluster.devices}
    requeued = 0

    def begin_request(did: str, mid: str, arrival_t: float,
                      now: float) -> None:
        """Start serving one request NOW (caller checked residency and,
        for timed service, slot availability).  Service time is frozen
        at admission occupancy."""
        r = rt[did]
        svc_s = svc.request_service_s(cluster.specs[mid],
                                      cluster.devices[did],
                                      r.pool(mid).busy + 1)
        cluster.begin_serve(did, mid, arrival_t, service_s=svc_s)
        if svc_s <= 0.0:
            cluster.end_serve(did, mid)      # instantaneous, slot-free
            return
        slot = r.pool(mid).acquire()
        inflight[did][(mid, slot)] = (arrival_t, max(now - arrival_t, 0.0))
        push(now + svc_s, _P_DONE, "serve_done", (did, mid, slot,
                                                  epoch[did]))

    def drain_waiting(did: str, mid: str, now: float) -> None:
        """Admit waiters into free decode slots, oldest first."""
        r = rt[did]
        q = r.wait_q(mid)
        while q and not r.pool(mid).full:
            begin_request(did, mid, q.popleft(), now)

    def dispatch(did: str, mid: str, arrival_t: float, now: float) -> None:
        """Serve, queue, or trigger a load for one routed request."""
        r = rt[did]
        m = cluster.replica(did, mid)
        if m.resident:
            if r.pool(mid).full:
                r.wait_q(mid).append(arrival_t)
                return
            begin_request(did, mid, arrival_t, now)
            return
        r.wait_q(mid).append(arrival_t)
        if not m.loading and mid not in r.load_queued:
            r.load_queued.add(mid)
            r.load_q.append(("load", mid))
        pump_loader(did, now)

    def pump_loader(did: str, now: float) -> None:
        """Start the next queued (re)load/migration if the serialized
        loader channel is free.  A gated device wakes FIRST: the
        SLEEP -> BARE ramp serializes on the same channel (nothing can
        ingest weights on a sleeping device -- the state machine would
        raise), and the queued loads start when the wake lands."""
        r = rt[did]
        if cluster.power_state(did) is PowerState.OFF:
            return      # revoked: queued work waits for preempt_restore
        if (r.loading is None and r.load_q
                and cluster.power_state(did) is PowerState.SLEEP):
            dt = cluster.start_wake(did)
            r.loading = WAKE_CHANNEL
            r.loading_until = now + dt
            push(now + dt, _P_DONE, "wake_done", (did, epoch[did]))
            return
        while r.loading is None and r.load_q:
            item = r.load_q.popleft()
            mid = item[-1]
            if item[0] == "load":
                m = cluster.replica(did, mid)
                if m.resident or m.loading:
                    # a migration raced the request here and landed (or
                    # is landing) the model: nothing left to load
                    r.load_queued.discard(mid)
                    if m.resident:
                        drain_waiting(did, mid, now)
                    continue
                dt = cluster.start_load(did, mid)
            else:                            # ("mig", src, mid)
                src = item[1]
                if rt[src].busy:
                    # source started working (possibly serving, or
                    # holding queued requests for, this very model)
                    # since the plan: defer to the next pass
                    continue
                m = cluster.replica(did, mid)
                if m.resident or m.loading:
                    # a request raced the plan and loaded it here;
                    # dedupe the source copy
                    if src != did and mid in cluster.managers[src].models:
                        src_m = cluster.managers[src].models[mid]
                        if src_m.resident:
                            cluster.managers[src].unload(mid)
                            cluster.sync_power(src)
                    continue
                src_m = cluster.managers[src].models.get(mid)
                if src_m is None or not src_m.resident:
                    continue                 # source evicted it meanwhile
                dt = cluster.start_migration(mid, src, did)
                cluster.sync_power(src)
            r.loading = mid
            r.loading_until = now + dt
            push(now + dt, _P_DONE, "load_done", (did, mid, epoch[did]))

    while heap:
        t, _phase, _s, kind, data = heapq.heappop(heap)
        if (kind in ("serve_done", "load_done", "wake_done")
                and data[-1] != epoch[data[0]]):
            continue      # orphaned by a preemption; device was reset
        cluster.advance_to(t)
        if kind == "arrival":
            (mid,) = data
            did = router.choose(mid, t, cluster)
            cluster.observe_arrival(mid, did, t)
            # pin the routed replica: queued demand must not be evicted
            # (by its armed idle timeout OR by make_room capacity
            # pressure) while the request waits for a slot or a load;
            # end_serve unpins and re-arms after serving
            rep = cluster.replica(did, mid)
            rep.pins += 1
            rep.evict_at = math.inf
            dispatch(did, mid, t, t)
            cluster.sync_power(did)
        elif kind == "wake_done":
            did, _ep = data
            rt[did].loading = None
            cluster.finish_wake(did)
            pump_loader(did, t)              # start the queued loads
            cluster.sync_power(did)
        elif kind == "load_done":
            did, mid, _ep = data
            r = rt[did]
            cluster.finish_load(did, mid)
            r.loading = None
            r.load_queued.discard(mid)
            m = cluster.managers[did].models[mid]
            if m.pins > 0:
                m.evict_at = math.inf        # queued demand stays pinned
            drain_waiting(did, mid, t)
            pump_loader(did, t)
            cluster.sync_power(did)
        elif kind == "serve_done":
            did, mid, slot, _ep = data
            inflight[did].pop((mid, slot), None)
            rt[did].pool(mid).release(slot)
            cluster.end_serve(did, mid)
            drain_waiting(did, mid, t)
            cluster.sync_power(did)
        elif kind == "autoscale":
            for act in sc.autoscaler.plan(cluster, t):
                if isinstance(act, ScaleOut):
                    r = rt[act.dst]
                    m = cluster.replica(act.dst, act.model_id)
                    q_slots, q_vram = cluster.queued_load_demand(act.dst)
                    lost_fit = (
                        cluster.free_slots(act.dst) - q_slots < 1
                        or cluster.free_vram_gb(act.dst) - q_vram
                        < cluster.specs[act.model_id].vram_gb)
                    queued_mig = any(item[-1] == act.model_id
                                     for item in r.load_q)
                    if (m.resident or m.loading or queued_mig
                            or act.model_id in r.load_queued or lost_fit):
                        continue      # raced a routed load/mig, lost fit
                    # the controller owns this replica's lifetime: it
                    # parks through lulls (held) until scale-in retires
                    # it -- that standing warmth is the over-provisioning
                    # parking tax the bench quantifies
                    m.held = True
                    r.load_queued.add(act.model_id)
                    r.load_q.append(("load", act.model_id))
                    sc.autoscaler.scale_outs += 1
                    pump_loader(act.dst, t)
                    cluster.sync_power(act.dst)
                elif cluster.scale_in(act.src, act.model_id):
                    sc.autoscaler.scale_ins += 1
            nxt = t + sc.autoscaler.tick_s
            if nxt < sc.horizon_s:
                push(nxt, _P_AUTO, "autoscale", ())
        elif kind == "consolidate":
            busy_map = {did: r.busy for did, r in rt.items()}
            for mv in sc.consolidator.plan(cluster, t, busy_map):
                rt[mv.dst].load_q.append(("mig", mv.src, mv.model_id))
                pump_loader(mv.dst, t)
                cluster.sync_power(mv.dst)
            # power gating rides the same tick: devices the packing
            # passes drained (and anything else settled at bare past the
            # wake-energy breakeven) fall below p_base to SLEEP
            for did in sc.consolidator.plan_gating(cluster, t, busy_map):
                cluster.gate_device(did)
            nxt = t + sc.consolidator.period_s
            if nxt < sc.horizon_s:
                push(nxt, _P_CONS, "consolidate", ())
        elif kind == "preempt_warn":
            # provider warning: stop placing on the device (routers,
            # autoscaler, consolidator targets all skip revoked ids);
            # in-flight work rides out the warning window
            (did,) = data
            cluster.revoked.add(did)
        elif kind == "preempt_off":
            (did,) = data
            cluster.revoked.add(did)
            epoch[did] += 1           # orphan outstanding completions
            r = rt[did]
            # collect every request the revocation strands, oldest
            # first: wait-queue entries (never started) keep their
            # arrival time; in-flight serves are cancelled -- their
            # count and charged wait move with them (conservation),
            # and the re-dispatch re-charges the full wait including
            # the preemption delay
            orphans: List[Tuple[float, str]] = []
            for mid in sorted(r._waiting):
                for arr_t in r._waiting[mid]:
                    orphans.append((arr_t, mid))
            for (mid, slot), (arr_t, wait) in sorted(inflight[did].items()):
                cluster.cancel_serve(did, mid, wait)
                orphans.append((arr_t, mid))
            inflight[did] = {}
            cluster.force_off(did)    # drops residents, meter -> OFF
            rt[did] = DeviceRuntime(sc.max_batch)   # queues/slots die too
            for arr_t, mid in sorted(orphans):
                ndid = router.choose(mid, t, cluster)
                # re-placement, not a new arrival: rates were already
                # observed at the true arrival -- just pin and dispatch
                rep = cluster.replica(ndid, mid)
                rep.pins += 1
                rep.evict_at = math.inf
                dispatch(ndid, mid, arr_t, t)
                cluster.sync_power(ndid)
                requeued += 1
        elif kind == "preempt_restore":
            (did,) = data
            cluster.restore_device(did)       # OFF -> BARE, placeable
            pump_loader(did, t)               # work queued mid-outage
            cluster.sync_power(did)
        if kind != "serve_done":      # serving never changes residency
            cluster.snapshot_replicas(t)

    # trailing idle out to the horizon (a load may overshoot it, exactly
    # as the single-device simulator lets the final burst overshoot)
    cluster.advance_to(max(sc.horizon_s, cluster.clock()))
    cluster.snapshot_replicas(cluster.clock())

    totals = cluster.device_totals()          # flushes every meter to now
    reports = []
    cold = reqs = 0
    latency = 0.0
    samples: List[float] = []
    fleet_segments: List[Tuple[float, float, float]] = []
    for did in sorted(cluster.devices):
        mm = cluster.managers[did]
        d_cold = sum(m.cold_starts for m in mm.models.values())
        d_reqs = sum(m.requests for m in mm.models.values())
        latency += sum(m.added_latency_s for m in mm.models.values())
        for m in mm.models.values():
            samples.extend(m.latency_samples)
        cold += d_cold
        reqs += d_reqs
        fleet_segments.extend(mm.meter.timeline)
        reports.append(DeviceReport(
            instance_id=did, sku=cluster.devices[did].sku.key,
            energy_wh=totals[did],
            parking_tax_wh=mm.meter.parking_tax_wh(),
            cold_starts=d_cold, requests=d_reqs,
            resident=mm.resident_ids(), meter_state=mm.meter.state.value,
            carbon_kg=dev_traces[did].carbon_for_segments(
                mm.meter.timeline),
            zone=zones[did],
            durations_s=mm.meter.durations(),
            wakes=mm.meter.wakes,
            gated_wh_saved=mm.meter.gated_wh_saved()))

    lb_nongated, cv_sum = (clairvoyant_bound(sc) if compute_bound
                           else (0.0, 0.0))
    energy = sum(r.total_wh for r in reports)
    mix = get_mix(sc.zone)
    state_wh: Dict[str, float] = {}
    state_s: Dict[str, float] = {}
    for r in reports:
        for k, v in r.energy_wh.items():
            if k != "total":
                state_wh[k] = state_wh.get(k, 0.0) + v
        for k, v in r.durations_s.items():
            state_s[k] = state_s.get(k, 0.0) + v
    zone_wh, zone_kg = zone_decomposition(reports)
    if multi_zone:
        # dollars and the scalar bookkeeping price each zone's joules at
        # that zone's rates; the carbon timeline integrates each
        # device's segments against ITS trace (device order unchanged)
        energy_usd = math.fsum(
            energy_cost_usd(wh, get_mix(z)) for z, wh in zone_wh.items())
        kg_flat = math.fsum(
            carbon_kg(wh, get_mix(z)) for z, wh in zone_wh.items())
        timeline = carbon_timeline_multi_kg(
            [(dev_traces[did], seg) for did in sorted(cluster.devices)
             for seg in cluster.managers[did].meter.timeline],
            end_s=sc.horizon_s) if detail else []
    else:
        energy_usd = energy_cost_usd(energy, mix)
        kg_flat = carbon_kg(energy, mix)
        timeline = carbon_timeline_kg(trace, fleet_segments,
                                      end_s=sc.horizon_s) if detail else []
    cost = price_fleet(sc.devices, reports, default_tier=sc.price_tier,
                       energy_usd=energy_usd)
    return FleetResult(
        router=router.name, horizon_s=sc.horizon_s, devices=reports,
        energy_wh=energy,
        parking_tax_wh=sum(r.parking_tax_wh for r in reports),
        cold_starts=cold, requests=reqs,
        added_latency_s_total=latency, migrations=cluster.migrations,
        lb_nongated_wh=lb_nongated, cv_per_model_wh=cv_sum,
        infra_usd=fleet_price_usd(sc.devices, sc.horizon_s, sc.price_tier),
        energy_usd=energy_usd,
        carbon_kg=math.fsum(r.carbon_kg for r in reports),
        carbon_kg_flat=kg_flat,
        carbon_trace_name=trace.name,
        carbon_timeline=timeline,
        power_timeline=fleet_segments,
        zone_energy_wh=zone_wh, zone_carbon_kg=zone_kg,
        transfer_wh=cluster.transfer_j / 3600.0,
        cross_zone_migrations=cluster.cross_zone_migrations,
        latencies_s=np.sort(np.asarray(samples, dtype=float)),
        replica_timeline={mid: list(log)
                          for mid, log in cluster.replica_log.items()},
        scale_outs=(sc.autoscaler.scale_outs if sc.autoscaler else 0),
        scale_ins=(sc.autoscaler.scale_ins if sc.autoscaler else 0),
        state_energy_wh=state_wh, state_durations_s=state_s,
        gates=cluster.gates,
        wakes=sum(r.wakes for r in reports),
        gated_wh_saved=math.fsum(r.gated_wh_saved for r in reports),
        cost_usd=cost.cost_usd, gpu_hours_usd=cost.gpu_hours_usd,
        device_gpu_usd=cost.device_gpu_usd,
        device_cost_usd=cost.device_cost_usd,
        zone_cost_usd=cost.zone_cost_usd, device_tiers=cost.device_tiers,
        preemptions=cluster.preemptions, requeued_requests=requeued,
        tier_billed_s=tier_billed_seconds(sc.devices, reports,
                                          sc.price_tier))


def zone_decomposition(reports: Sequence[DeviceReport]
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per-zone (energy_wh, carbon_kg) decompositions of a device-report
    list.  ``fsum`` per zone, so the values are correctly rounded and
    the decomposition sums back to the global totals regardless of
    device order (shared by ``run_fleet`` and ``run_mega``)."""
    zones = sorted({r.zone for r in reports})
    wh = {z: math.fsum(r.total_wh for r in reports if r.zone == z)
          for z in zones}
    kg = {z: math.fsum(r.carbon_kg for r in reports if r.zone == z)
          for z in zones}
    return wh, kg


# ---------------------------------------------------------------------------
# Clairvoyant lower bound (offline, fleet-best constants).
# ---------------------------------------------------------------------------

def _best_constants(sc: FleetScenario, fm: FleetModel) -> Tuple[float, float]:
    """(min DVFS step across devices, min above-bare reload energy)."""
    step_min = min(d.profile.dvfs_step_w for d in sc.devices)
    load_min = math.inf
    for d in sc.devices:
        if fm.spec.loader is not None:
            ld = fm.spec.loader
        else:
            ld = loader_from_checkpoint(fm.spec.model_id,
                                        fm.spec.checkpoint_bytes, d.profile)
        load_min = min(load_min,
                       max(ld.p_load_w - d.profile.p_base_w, 0.0)
                       * ld.t_load_s)
    return step_min, load_min


def clairvoyant_bound(sc: FleetScenario) -> Tuple[float, float]:
    """(lb_nongated_wh, cv_per_model_wh) -- see module docstring.

    Assumes the paper's evaluation convention of service energy held
    constant across policies (service_s == 0); with service enabled the
    bound still excludes service energy and is simply looser.  SCOPE:
    the ``p_base`` floor term assumes devices never sleep, so these are
    floors for NON-GATED runs only.  A power-GATED run (Consolidator
    ``gate_drained_devices``) can legitimately land BELOW both values --
    that is the point of gating -- which is why ``FleetResult`` reports
    them under the explicitly scoped name ``lb_nongated_wh`` rather
    than as a universal lower bound.
    """
    base_j = sum(d.profile.p_base_w for d in sc.devices) * sc.horizon_s
    extras = []
    for fm in sc.models:
        step_min, load_min = _best_constants(sc, fm)
        arr = sorted(float(a) for a in fm.arrivals_s
                     if 0.0 <= a < sc.horizon_s)
        extra = 0.0
        if not arr:
            extras.append(0.0)
            continue
        if fm.spec.home is not None:
            gaps = np.diff([0.0] + arr)       # starts warm at t=0
        else:
            extra += load_min                 # must load at least once
            gaps = np.diff(arr)
        for g in gaps:
            extra += min(step_min * g, load_min)
        extras.append(extra)
    lb_nongated = (base_j + (max(extras) if extras else 0.0)) / 3600.0
    cv_sum = (base_j + sum(extras)) / 3600.0
    return lb_nongated, cv_sum


# ---------------------------------------------------------------------------
# Convenience constructors.
# ---------------------------------------------------------------------------

def mixed_fleet_scenario(policy_factory, router, *,
                         consolidate: Union[bool, Consolidator] = False,
                         n_models: int = 10,
                         fleet: str = "2xh100+2xa100+2xl40s",
                         horizon_s: float = DAY, seed: int = 100,
                         service_s: float = 0.0,
                         service_model: Optional[ServiceTimeModel] = None,
                         max_batch: int = 4,
                         autoscaler: Optional[ReplicaAutoscaler] = None,
                         carbon_trace: Union[CarbonTrace, str, None] = None,
                         zone: str = "USA") -> FleetScenario:
    """The reference mixed-fleet scenario (shared by bench_fleet and the
    fleet_parking example): N models under a diurnal + bursty +
    heavy-tail + steady traffic rotation on a mixed-architecture fleet.

    Checkpoints span ~5..5+3.5(N-1) GB so placement interacts with
    capacity; every model starts prewarmed round-robin (the always-on
    operating point the paper says industry defaults to).

    ``consolidate`` accepts a configured ``Consolidator`` (e.g. the
    carbon-aware one) or a bool for the default; ``carbon_trace``
    passes through to ``FleetScenario.carbon_trace``."""
    from repro_torch.core import traffic
    patterns = ["diurnal", "bursty", "mmpp", "steady"]
    devices = build_fleet(fleet)
    models: List[FleetModel] = []
    gb = 1024 ** 3
    for i in range(n_models):
        arr = traffic.PATTERNS[patterns[i % len(patterns)]](seed=seed + i)
        arr = arr[arr < horizon_s]
        ckpt_gb = 5.0 + 3.5 * i
        spec = FleetModelSpec(
            model_id=f"m{i}", policy_factory=policy_factory,
            checkpoint_bytes=int(ckpt_gb * gb), vram_gb=ckpt_gb * 1.1,
            home=devices[i % len(devices)].instance_id)
        models.append(FleetModel(spec, arr))
    if isinstance(consolidate, Consolidator):
        cons: Optional[Consolidator] = consolidate
    else:
        cons = Consolidator() if consolidate else None
    return FleetScenario(devices=devices, models=models, router=router,
                         horizon_s=horizon_s, service_s=service_s,
                         service_model=service_model, max_batch=max_batch,
                         consolidator=cons, autoscaler=autoscaler,
                         carbon_trace=carbon_trace, zone=zone)


def single_device_scenario(arrivals_s: Sequence[float], policy_factory,
                           loader, sku_key: str = "h100", *,
                           horizon_s: float = DAY, start_warm: bool = True,
                           service_s: float = 0.0, max_batch: int = 1,
                           autoscaler: Optional[ReplicaAutoscaler] = None
                           ) -> FleetScenario:
    """1 device x 1 model -- the fleet degenerate case that must agree
    with ``core.simulator.simulate`` (tested to 1e-6 Wh).  max_batch
    defaults to 1 because the reference simulator serializes service;
    with service_s=0 any slot count is equivalent (tested)."""
    devices = build_fleet([sku_key])
    spec = FleetModelSpec(
        model_id="m0", policy_factory=policy_factory, loader=loader,
        home=devices[0].instance_id if start_warm else None)
    return FleetScenario(devices=devices,
                         models=[FleetModel(spec, list(arrivals_s))],
                         router="warm-first", horizon_s=horizon_s,
                         service_s=service_s, max_batch=max_batch,
                         autoscaler=autoscaler)
