"""Replica auto-scaling: scale hot routes out, retire over-provisioned
replicas when their parking tax exceeds the reload they would save.

The paper's breakeven model says the energy-optimal treatment of a
parked model is set by its arrival rate and loading latency, not its
size (Eqs. 12-13).  Lifted to the replica-set level the same ski rental
answers BOTH autoscaling questions:

  * scale OUT when a route's live demand -- busy decode slots plus
    queued requests, from the fleet event loop's published occupancy --
    presses against the warm capacity of its replica set, AND the
    per-replica arrival gap after scaling stays inside the target
    device's breakeven window (a replica that would immediately sit
    past T* would just re-evict: loading it is pure waste).  Placement
    picks the cheapest feasible device by ``catalog.scaleout_cost_j``:
    above-bare load energy + marginal parking power (zero on a device
    whose context is already up) held for the expected demand window.

  * scale IN when the idlest replica's parking tax outruns its reload:
    its observed per-replica arrival gap (``Cluster.rep_rates``) exceeds
    the breakeven window implied by its marginal parking power, and the
    remaining replicas can absorb the route's live load with slack.  A
    replica whose device hosts other live contexts parks at ZERO
    marginal watts and is never retired for energy reasons -- capacity
    pressure (``make_room``) handles VRAM, not the autoscaler.

The controller runs inside the fleetsim event loop as periodic
``autoscale`` ticks (like the Consolidator): ``plan`` returns actions,
the event loop applies them through the device loader channels -- so a
scale-out load serializes behind in-flight loads and overlaps decode
exactly like any other load, and every joule it costs is metered.

Safety invariants (property-tested in tests/test_fleet_properties.py):
``max_replicas=1`` plans nothing, a single-device fleet plans nothing
(the 1-device x 1-model equivalence anchor to core/simulator.py
survives with the autoscaler enabled), and scale-in never drops a
route's last replica, a pinned replica, or one with work in flight.
Retired replicas leave their devices to the Consolidator's packing
pass, which can then drain the freed context windows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Union

from repro_torch.core.power_states import PowerState
from repro_torch.fleet.carbon import CarbonTrace, _J_PER_KWH
from repro_torch.fleet.catalog import (above_base_load_j, marginal_park_w,
                                 scaleout_cost_j, wake_cost_j,
                                 wake_cost_kg)
from repro_torch.fleet.cluster import Cluster


@dataclasses.dataclass(frozen=True)
class ScaleOut:
    """Plan action: load one more warm replica of ``model_id`` on
    device ``dst`` (applied through the device's loader channel)."""
    model_id: str
    dst: str


@dataclasses.dataclass(frozen=True)
class ScaleIn:
    """Plan action: retire the warm replica of ``model_id`` on device
    ``src`` (applied via ``Cluster.scale_in``, which re-checks safety)."""
    model_id: str
    src: str


Action = Union[ScaleOut, ScaleIn]


class ReplicaAutoscaler:
    """Periodic scale-out/in controller over per-route replica sets.

    Knobs:
      tick_s        controller period (seconds of sim time).
      max_replicas  hard cap per route; 1 disables the controller
                    entirely (trace-identical to no autoscaler).
      pressure_hi   scale out when live demand (busy slots + waiters)
                    reaches this fraction of the set's decode capacity.
      pressure_lo   scale in only when demand fits under this fraction
                    of the SHRUNK set's capacity (hysteresis band).
      margin        both breakeven tests require benefit >= margin *
                    cost; >1 biases toward fewer scale events.
      cooldown_s    per-route minimum gap between actions (damps
                    oscillation on bursty traffic).
      patience_s    scale-in additionally waits for at least this much
                    replica idle time.  The raw breakeven hold is tens
                    of seconds for derived loaders, which would retire a
                    held replica the moment a burst ends and put the
                    NEXT burst back on a cold start -- patience keeps
                    the latency half of the trade from thrashing.
      carbon_aware  price the breakeven tests in kgCO2e against the
                    run's grid-intensity trace (bound by ``run_fleet``
                    via ``set_carbon_trace``) instead of joules: the
                    breakeven hold SHRINKS when the coming window is
                    dirtier than the daily mean (standing warmth is
                    carbon-expensive now; retire sooner, reload in a
                    cleaner hour) and STRETCHES through clean windows;
                    scale-out placement prices its load burst at the
                    current intensity, so prewarm-style capacity buys
                    drift into low-intensity windows.  Flat traces
                    reproduce the energy decisions exactly.
    """

    def __init__(self, *, tick_s: float = 60.0, max_replicas: int = 3,
                 pressure_hi: float = 0.5, pressure_lo: float = 0.25,
                 margin: float = 1.0, cooldown_s: float = 300.0,
                 patience_s: float = 1800.0, carbon_aware: bool = False):
        if tick_s <= 0:
            raise ValueError("tick period must be positive")
        if max_replicas < 1:
            raise ValueError("need at least one replica per route")
        if not 0.0 < pressure_lo <= pressure_hi:
            raise ValueError("need 0 < pressure_lo <= pressure_hi")
        self.tick_s = tick_s
        self.max_replicas = max_replicas
        self.pressure_hi = pressure_hi
        self.pressure_lo = pressure_lo
        self.margin = margin
        self.cooldown_s = cooldown_s
        self.patience_s = patience_s
        self.carbon_aware = carbon_aware
        self.carbon_trace: Optional[CarbonTrace] = None
        self._last_action: Dict[str, float] = {}
        self.scale_outs = 0
        self.scale_ins = 0

    def reset(self) -> None:
        """Clear per-run state (cooldowns, action counters); run_fleet
        calls this so one controller instance can drive many runs."""
        self._last_action.clear()
        self.scale_outs = 0
        self.scale_ins = 0

    def set_carbon_trace(self, trace: CarbonTrace) -> None:
        """Bind the run's intensity trace (called by ``run_fleet``);
        only consulted when ``carbon_aware`` is set."""
        self.carbon_trace = trace

    def _trace(self) -> Optional[CarbonTrace]:
        """The active trace, or None when carbon pricing is off (not
        carbon_aware, no trace bound, or a flat trace -- all three are
        energy-identical, so one code path serves them)."""
        t = self.carbon_trace if self.carbon_aware else None
        return None if (t is None or t.is_flat) else t

    # -- per-route signals --------------------------------------------------
    @staticmethod
    def route_demand(cluster: Cluster, model_id: str) -> int:
        """Live demand: busy decode slots + queued requests, fleet-wide
        (waiters can sit on a device whose replica is still loading)."""
        return sum(cluster.busy_slots(did, model_id)
                   + cluster.waiting_requests(did, model_id)
                   for did in cluster.devices)

    @staticmethod
    def _replica_idle_s(cluster: Cluster, device_id: str, model_id: str,
                        now_s: float) -> float:
        """How idle this replica is: the larger of its EWMA inter-arrival
        gap and the time since its LAST arrival.  The elapsed term
        matters -- the EWMA only updates on arrivals, so a replica whose
        traffic stopped would otherwise keep its burst-time (small) gap
        forever and never look idle.  inf when never routed a request
        (the prime scale-in victim)."""
        est = cluster.rep_rates.get((device_id, model_id))
        if est is None or est.last_arrival is None:
            return math.inf
        elapsed = max(now_s - est.last_arrival, 0.0)
        if est.gap_s is None:
            return elapsed
        return max(est.expected_gap_s(), elapsed)

    def _breakeven_hold_s(self, cluster: Cluster, device_id: str,
                          model_id: str, now_s: float = 0.0) -> float:
        """Replica-level T*: how long this replica may park before its
        marginal tax buys a reload.  Infinite at zero marginal watts.

        Uses the paper's Eq.-12 convention (FULL loading power), like
        the default Breakeven eviction policy: the derived per-arch
        loaders spend most of their window near bare idle, so the
        energy-exact convention would price reloads at almost nothing
        and never let a replica stand.

        Carbon mode reprices the same ski rental in kgCO2e with a
        first-order intensity correction: parking over the coming
        window is weighed at the window's mean intensity, the eventual
        reload at the daily mean (its phase is unknown), so

            hold_c = hold * i_daily / i(now .. now+hold)

        -- shorter through dirty hours, longer through clean ones.

        Args:
          now_s: current sim time (anchors the carbon window; unused
                 in energy mode).
        Returns: hold in seconds (may be ``inf``)."""
        dev = cluster.devices[device_id]
        others_on = any(
            (m.resident or m.loading) and m.model_id != model_id
            for m in cluster.managers[device_id].models.values())
        park_w = marginal_park_w(dev, others_on)
        if park_w <= 0.0:
            return math.inf
        hold = cluster.loader_for(model_id, device_id).load_energy_j / park_w
        trace = self._trace()
        if trace is not None:
            window = trace.mean(now_s, now_s + hold)
            if window > 0.0:
                hold *= trace.daily_mean_kg_per_kwh / window
        return hold

    # -- planning -----------------------------------------------------------
    def plan(self, cluster: Cluster, now_s: float) -> List[Action]:
        """One controller pass; pure decision (the event loop applies,
        and counts only the actions that actually land).

        A single-device fleet can never scale (the replica set IS the
        device), and max_replicas=1 disables the controller outright --
        both keep the single-simulator equivalence anchor exact.
        Scale-outs emitted in the SAME pass reserve their slot/VRAM in a
        ledger, so two hot routes cannot both claim the last fit on one
        device before either load is applied.
        """
        if self.max_replicas <= 1 or len(cluster.devices) <= 1:
            return []
        actions: List[Action] = []
        reserved: Dict[str, List[float]] = {}    # dst -> [slots, vram_gb]
        for mid in sorted(cluster.specs):
            last = self._last_action.get(mid)
            if last is not None and now_s - last < self.cooldown_s:
                continue
            act = self._plan_route(cluster, mid, now_s, reserved)
            if act is not None:
                actions.append(act)
                self._last_action[mid] = now_s
                if isinstance(act, ScaleOut):
                    r = reserved.setdefault(act.dst, [0, 0.0])
                    r[0] += 1
                    r[1] += cluster.specs[mid].vram_gb
        return actions

    def _plan_route(self, cluster: Cluster, mid: str, now_s: float,
                    reserved: Dict[str, List[float]]) -> Optional[Action]:
        resident = cluster.locations(mid, include_loading=False)
        pending = cluster.pending_scaleouts(mid)
        members = sorted(set(resident) | set(pending))
        n = len(members)
        if n == 0:
            return None           # cold route: first load is routing's job
        capacity = sum(cluster.decode_slots(d) for d in members)
        demand = self.route_demand(cluster, mid)

        if (n < self.max_replicas and capacity > 0
                and demand >= self.pressure_hi * capacity):
            waiting = sum(cluster.waiting_requests(d, mid)
                          for d in cluster.devices)
            return self._plan_scale_out(cluster, mid, members, n, now_s,
                                        reserved,
                                        forced=waiting >= capacity)

        if n > 1 and not pending and resident:
            return self._plan_scale_in(cluster, mid, resident, demand,
                                       now_s)
        return None

    @staticmethod
    def _fits_reserving(cluster: Cluster, device_id: str, model_id: str,
                        reserved: Dict[str, List[float]]) -> bool:
        """fits() plus what same-pass actions reserved AND what earlier
        ticks left queued on the loader channel (queued-not-started
        loads are invisible to occupancy, but will claim their VRAM when
        they pump -- ignoring them would overcommit the device and
        make_room would then cannibalize a freshly landed replica)."""
        slots, vram = reserved.get(device_id, (0, 0.0))
        q_slots, q_vram = cluster.queued_load_demand(device_id)
        return (cluster.free_slots(device_id) - slots - q_slots >= 1
                and cluster.free_vram_gb(device_id) - vram - q_vram
                >= cluster.specs[model_id].vram_gb)

    def _plan_scale_out(self, cluster: Cluster, mid: str, members: List[str],
                        n: int, now_s: float,
                        reserved: Dict[str, List[float]], *,
                        forced: bool = False) -> Optional[ScaleOut]:
        """Demand said scale; pick WHERE by expected joules.

        Per candidate the Eq.-13 worthwhile test asks whether the new
        replica's traffic share (expected gap x grown set size) would
        re-arrive inside the device's breakeven hold -- a replica that
        would park past T* is pure tax, so it is only bought when the
        route is FORCED (queued demand exceeds a full batch round: the
        SLO is already paying in seconds, so we pay in joules instead).
        Cost per candidate: above-bare load energy + marginal parking
        power over the expected demand window (capped at the breakeven
        hold, the most a standing replica can owe before scale-in
        retires it); loader-channel backlog breaks ties so the new
        capacity lands soonest."""
        gap = cluster.rates[mid].expected_gap_s()
        cands = [d for d in sorted(cluster.devices)
                 if d not in members
                 and d not in cluster.revoked   # spot warning/outage
                 and self._fits_reserving(cluster, d, mid, reserved)]
        best, best_key = None, None
        trace = self._trace()
        for d in cands:
            dev = cluster.devices[d]
            ld = cluster.loader_for(mid, d)
            hold = self._breakeven_hold_s(cluster, d, mid, now_s)
            if not forced and gap * (n + 1) > self.margin * hold:
                continue
            window = min(gap * (n + 1), hold)
            ctx_on = cluster.context_on(d)
            # a gated candidate pays its wake on top: ramp energy above
            # sleep + the bare-minus-sleep delta over the demand window
            # (in carbon mode, at the current window's intensity)
            wake_j = wake_cost_j(dev, window) \
                if cluster.power_state(d) is PowerState.SLEEP else 0.0
            if trace is None:
                cost = scaleout_cost_j(dev, ld, window, context_on=ctx_on) \
                    + wake_j
            else:
                # kgCO2e analogue of scaleout_cost_j: the load burst at
                # the CURRENT intensity (this is what drags prewarm-style
                # capacity buys into clean windows), the marginal parking
                # over the expected demand window
                t_warm = now_s + ld.t_load_s
                load_kg = above_base_load_j(dev, ld) \
                    * trace.mean(now_s, t_warm) / _J_PER_KWH
                park_kg = marginal_park_w(dev, ctx_on) \
                    * trace.integral(t_warm, t_warm + max(window, 0.0)) \
                    / _J_PER_KWH
                wake_kg = wake_cost_kg(dev, trace, now_s, t_warm,
                                       window) if wake_j > 0.0 else 0.0
                cost = load_kg + park_kg + wake_kg
            lag_s = cluster.load_backlog_s(d, now_s) \
                + (dev.profile.wake_latency_s if wake_j > 0.0 else 0.0)
            key = (cost, lag_s, d)
            if best_key is None or key < best_key:
                best, best_key = d, key
        return ScaleOut(mid, best) if best is not None else None

    def _plan_scale_in(self, cluster: Cluster, mid: str,
                       resident: List[str], demand: int, now_s: float
                       ) -> Optional[ScaleIn]:
        # victims: safe to retire now, idlest first
        victims = [
            d for d in resident
            if cluster.busy_slots(d, mid) == 0
            and cluster.waiting_requests(d, mid) == 0
            and cluster.managers[d].models[mid].pins == 0]
        victims.sort(key=lambda d: (-self._replica_idle_s(cluster, d, mid,
                                                          now_s), d))
        for d in victims:
            shrunk_cap = sum(cluster.decode_slots(x) for x in resident
                             if x != d)
            if demand > self.pressure_lo * shrunk_cap:
                return None       # remaining set would run hot
            idle = self._replica_idle_s(cluster, d, mid, now_s)
            bar = max(self.margin * self._breakeven_hold_s(cluster, d, mid,
                                                           now_s),
                      self.patience_s)
            if idle >= bar:
                return ScaleIn(mid, d)
            # this one still earns its keep at ITS device's breakeven
            # hold; a less idle replica on a cheaper-loading device may
            # not -- keep looking
        return None
