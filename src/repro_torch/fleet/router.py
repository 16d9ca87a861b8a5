"""Request routing + consolidation across a heterogeneous fleet.

Routing answers: which device serves the next request for model m?
The strategies span the design space the paper's cluster-scale question
opens:

  * warm-first      -- never cold-start when a warm replica exists;
                       placement falls back to least-loaded.
  * least-loaded    -- classic load balancing, blind to warmth (the
                       baseline that shows why energy-aware routing
                       matters: it sprays cold starts).
  * energy-greedy   -- myopic joules: place a cold model where
                       (above-bare load energy + marginal parking
                       energy until the expected next arrival) is
                       minimal.  "Marginal" is the key word: a device
                       that already has a live context has paid its
                       DVFS step, so packing there parks for free.
  * breakeven-aware -- architecture-aware steady state: adds the
                       per-arrival-period ski-rental cost
                       min(step * E[gap], reload) so models with
                       sub-breakeven traffic land on low-step devices
                       (A100) and hot models on fast-loading ones.
  * slo-aware       -- energy min subject to a p99 added-latency
                       budget: estimates each candidate's queue wait +
                       cold-start time from live slot occupancy and
                       loader backlog, routes energy-greedy inside the
                       budget, latency-greedy when nothing fits.

  * carbon-aware    -- slo-aware's latency machinery with the cold-
                       placement score priced in kgCO2e against the
                       run's grid-intensity trace (fleet/carbon.py):
                       the immediate load burst and near-term parking
                       are priced at the CURRENT intensity window, the
                       eventual reload at the daily mean -- so high-
                       intensity hours push placements onto devices
                       that park at zero marginal watts, and cold
                       starts drift toward low-intensity windows.

Consolidation is the placement half: periodically migrate parked models
off lightly-packed devices onto already-on devices with room, so the
drained device falls back to ``p_base_w``.  The benefit side of the
cost test is exact, not estimated: without the migration the source
keeps its context until its LAST armed idle timeout fires, so draining
it now saves ``dvfs_step_w * (max evict_at - now)``.  In carbon-aware
mode the same windows are integrated against the intensity trace, so a
migration whose load burst lands in a trough but whose saving spans the
evening peak clears the margin earlier -- deferrable packing work
shifts into low-intensity windows without changing the safety rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core.breakeven import breakeven_seconds
from repro_torch.core.power_states import PowerState, gate_breakeven_s
from repro_torch.fleet.carbon import CarbonTrace, _J_PER_KWH
from repro_torch.fleet.catalog import (above_base_load_j, marginal_park_w,
                                 wake_cost_j, wake_cost_kg)
from repro_torch.fleet.cluster import Cluster


def _above_base_load_j(cluster: Cluster, model_id: str, device_id: str
                       ) -> float:
    """Above-bare reload energy, from the shared catalog cost model (one
    formula for routers, consolidator, and autoscaler placement)."""
    return above_base_load_j(cluster.devices[device_id],
                             cluster.loader_for(model_id, device_id))


class Router:
    """Picks a device for one request; stateless across requests (all
    adaptivity lives in the cluster's rate estimators)."""

    name = "base"

    def choose(self, model_id: str, t_s: float, cluster: Cluster) -> str:
        """Pick the device that serves this request.

        Args:
          model_id: the requested model (registered on the cluster).
          t_s:      arrival time (sim seconds).
          cluster:  live fleet state (residency, occupancy, rates).
        Returns: the chosen device's ``instance_id``."""
        raise NotImplementedError

    # -- shared helpers -----------------------------------------------------
    def _placeable(self, model_id: str, cluster: Cluster) -> List[str]:
        """Placement candidates: devices that fit, revoked ones (spot
        warning/outage in force) excluded.  Best-effort fallbacks relax
        fit before they relax revocation -- only an all-revoked fleet
        places on a revoked device (requests must route SOMEWHERE for
        the conservation invariant; they will be orphaned and re-queued
        when the OFF lands)."""
        alive = [did for did in sorted(cluster.devices)
                 if did not in cluster.revoked]
        fits = [did for did in alive if cluster.fits(did, model_id)]
        return fits or alive or sorted(cluster.devices)   # best effort

    def _least_loaded(self, model_id: str, cluster: Cluster) -> str:
        return min(self._placeable(model_id, cluster),
                   key=lambda did: (cluster.occupancy(did),
                                    -cluster.free_vram_gb(did), did))

    def _warm(self, model_id: str, cluster: Cluster) -> Optional[str]:
        """Least-pressure member of the warm replica set.  With one
        replica this is the old single-location behaviour; once the
        autoscaler grows the set, every router spreads requests to the
        member with the shortest queue (waiters, then busy slots, then
        stable id) instead of hot-spotting the first device.  A replica
        still mid-load counts as a FULL pool of busy slots, so it never
        outranks a resident replica with free capacity (requests would
        otherwise park behind the load residual)."""
        locs = cluster.locations(model_id, include_loading=True)
        # a warm replica on a revoked device is about to vanish: do not
        # route new work there (unless it is the only copy anywhere)
        live = [d for d in locs if d not in cluster.revoked]
        locs = live or locs
        if not locs:
            return None

        def key(d: str):
            m = cluster.managers[d].models.get(model_id)
            loading_penalty = 0 if (m is not None and m.resident) \
                else cluster.decode_slots(d)
            return (cluster.waiting_requests(d, model_id),
                    cluster.busy_slots(d, model_id) + loading_penalty, d)

        return min(locs, key=key)

    def _joule_score(self, model_id: str, cluster: Cluster, *,
                     steady_state: bool):
        """Scoring key for cold placement, shared by the energy-aware
        routers: above-bare load energy + MARGINAL parking energy until
        the expected next arrival (a context-on device has already paid
        its DVFS step, so packing there parks for free).  With
        ``steady_state`` the per-arrival-period ski-rental cost
        min(step * E[gap], reload) is added, making low-step devices win
        for sub-breakeven traffic.  A GATED (sleeping) candidate also
        pays its wake cost -- ramp energy above sleep plus the
        bare-minus-sleep delta over the expected hold -- so routers only
        wake a device when cheaper watts genuinely beat staying on an
        already-awake one."""
        gap = cluster.rates[model_id].expected_gap_s()

        def score(did: str) -> Tuple[float, str]:
            prof = cluster.devices[did].profile
            ld = cluster.loader_for(model_id, did)
            load_j = _above_base_load_j(cluster, model_id, did)
            step_w = marginal_park_w(cluster.devices[did],
                                     cluster.context_on(did))
            t_star = breakeven_seconds(ld, prof, paper_convention=False)
            park_j = step_w * min(gap, t_star)
            wake_j = 0.0
            if cluster.power_state(did) is PowerState.SLEEP:
                wake_j = wake_cost_j(cluster.devices[did],
                                     min(gap, t_star))
            if steady_state:
                return (load_j + wake_j
                        + min(step_w * gap, load_j + park_j), did)
            return (load_j + wake_j + park_j, did)

        return score


class WarmFirstRouter(Router):
    """Never cold-start when a warm replica exists (the parking tax is
    already paid there -- Eq. 1's context term); placement for cold
    models falls back to least-loaded."""

    name = "warm-first"

    def choose(self, model_id, t_s, cluster) -> str:
        warm = self._warm(model_id, cluster)
        if warm is not None:
            return warm
        return self._least_loaded(model_id, cluster)


class LeastLoadedRouter(Router):
    """Classic load balancing, blind to warmth: the baseline that
    sprays cold starts and shows why energy-aware routing matters."""

    name = "least-loaded"

    def choose(self, model_id, t_s, cluster) -> str:
        return self._least_loaded(model_id, cluster)


class EnergyGreedyRouter(Router):
    """Myopic joules for the imminent cold start + park-until-next-arrival."""

    name = "energy-greedy"
    steady_state = False

    def choose(self, model_id, t_s, cluster) -> str:
        warm = self._warm(model_id, cluster)
        if warm is not None:
            return warm
        return min(self._placeable(model_id, cluster),
                   key=self._joule_score(model_id, cluster,
                                         steady_state=self.steady_state))


class BreakevenRouter(EnergyGreedyRouter):
    """Architecture-aware breakeven routing:
    immediate load cost + expected per-period ski-rental cost, so the
    device whose (dvfs_step_w, t_load) pair minimizes expected joules
    wins even when every candidate is currently bare."""

    name = "breakeven-aware"
    steady_state = True


class SLOAwareRouter(Router):
    """Energy minimization subject to a per-request latency budget.

    The router estimates the added latency (queue wait + cold start)
    a request would see on every candidate device, from the live
    concurrency state the fleet event loop publishes through the
    cluster: loader-channel backlog, decode-slot occupancy, and
    per-model wait-queue depth.  Among devices whose estimate fits the
    budget it picks the energy-greedy choice (warm replicas are free);
    when NO device fits -- e.g. the model is cold everywhere and its
    load alone blows the budget -- it degrades to latency-greedy, which
    is what keeps the realized p99 pinned near the best achievable
    rather than wherever cheap joules happen to live.  ``budget_s`` is
    the p99 added-latency target the operator configures."""

    name = "slo-aware"

    def __init__(self, budget_s: float = 60.0, *, headroom: float = 1.0):
        if budget_s <= 0:
            raise ValueError("budget must be positive")
        self.budget_s = budget_s
        self.headroom = headroom      # <1.0 routes against a tighter bar

    # -- latency estimate ---------------------------------------------------
    def estimated_wait_s(self, model_id: str, device_id: str, t_s: float,
                         cluster: Cluster) -> float:
        """Added latency one request would see on ``device_id`` NOW:
        queue rounds for a warm replica, load residual for a loading
        one, loader-channel backlog + own load when cold.

        Args: as ``Router.choose`` plus the candidate ``device_id``.
        Returns: estimated seconds of queue wait + cold-start time."""
        m = cluster.managers[device_id].models.get(model_id)
        svc = cluster.service_model
        svc_s = 0.0
        if svc is not None:
            busy = cluster.busy_slots(device_id, model_id)
            svc_s = svc.request_service_s(cluster.specs[model_id],
                                          cluster.devices[device_id],
                                          max(busy, 1))
        waiting = cluster.waiting_requests(device_id, model_id)
        slots = max(cluster.decode_slots(device_id), 1)
        if m is not None and m.resident:
            pool_full = cluster.busy_slots(device_id, model_id) >= slots
            if not pool_full and waiting == 0:
                return 0.0
            # FIFO rounds through the batch until our turn comes up
            return math.ceil((waiting + 1) / slots) * svc_s
        if m is not None and m.loading:
            # the load is in flight: only its residual can delay us
            # (loads queued behind it start after we already serve)
            return (cluster.load_residual_s(device_id, t_s)
                    + (waiting // slots) * svc_s)
        # cold: whatever the loader channel holds, then our own load
        # (excluded from the backlog if a prior request already queued
        # it).  A still-gated device adds its wake latency up front; a
        # wake ramp already in flight is counted by the channel residual.
        backlog = cluster.load_backlog_s(device_id, t_s,
                                         exclude_model=model_id)
        if cluster.power_state(device_id) is PowerState.SLEEP:
            backlog += cluster.devices[device_id].profile.wake_latency_s
        return backlog + cluster.loader_for(model_id, device_id).t_load_s

    def _cold_score(self, model_id: str, t_s: float, cluster: Cluster):
        """Scoring key used for cold placement among budget-feasible
        candidates; subclasses swap the objective (joules here, kgCO2e
        in ``CarbonAwareRouter``) without touching the SLO machinery."""
        return self._joule_score(model_id, cluster, steady_state=True)

    def choose(self, model_id, t_s, cluster) -> str:
        warm = set(cluster.locations(model_id, include_loading=True))
        # pending scale-outs are FUTURE capacity: their load is already
        # paid for, so they compete at zero joules -- the router parks
        # requests behind a landing replica instead of cold-starting a
        # third copy elsewhere
        pending = set(cluster.pending_scaleouts(model_id))
        cands = sorted(set(self._placeable(model_id, cluster))
                       | warm | pending)
        # spot warning/outage: drop revoked candidates (their warmth or
        # pending capacity is about to vanish) unless nothing else is up
        live = [d for d in cands if d not in cluster.revoked]
        cands = live or cands
        est = {d: self.estimated_wait_s(model_id, d, t_s, cluster)
               for d in cands}
        budget = self.budget_s * self.headroom
        ok = [d for d in cands if est[d] <= budget]
        if not ok:                    # infeasible: minimize latency instead
            return min(cands, key=lambda d: (est[d], d))
        score = self._cold_score(model_id, t_s, cluster)

        def key(d: str):
            joules = 0.0 if d in warm or d in pending else score(d)[0]
            return (joules, est[d], d)

        return min(ok, key=key)


class CarbonAwareRouter(SLOAwareRouter):
    """SLO-aware routing with the cold-placement objective in kgCO2e.

    Keeps slo-aware's entire latency estimate/budget machinery (warm
    replicas and pending scale-outs still route free) but prices the
    cold-placement ski rental against the run's grid-intensity trace:

      score(d) = load_now + min(park_through, park_T* + reload_later)

    where ``load_now`` is the above-bare load burst integrated over
    [t, t+t_load] at the CURRENT intensity, ``park_through`` holds the
    marginal DVFS step until the expected next arrival (trace-priced),
    and ``reload_later`` prices the eventual reload at the daily-mean
    intensity (its phase is unknown).  With a flat trace every window
    weighs the same and the score reduces to slo-aware's joule score
    (delegated exactly, so flat-trace runs are trace-identical).

    Args:
    Per-device zones (the follow-the-sun tentpole): when the fleet
    spans electricity zones, ``run_fleet`` binds each device's LOCAL
    intensity trace on the cluster (``cluster.device_traces``) and the
    score prices every candidate against its own zone's trace -- a cold
    start during Germany's evening peak lands on the US device whose
    solar trough is live, even though both candidates are identical
    hardware.  ``zone_aware=False`` restores zone-blind scoring (every
    candidate priced against the scenario trace), which is the
    counterfactual the benchmarks compare against.  Single-zone fleets
    bind the SAME trace object to every device, so this path is
    bit-identical to the pre-zone scoring.

    Args:
      budget_s:   p99 added-latency budget (as ``SLOAwareRouter``).
      headroom:   route against ``budget_s * headroom``.
      trace:      ``CarbonTrace`` to price against; ``run_fleet`` binds
                  the scenario's resolved trace automatically.
      zone_aware: price candidates at their device-local intensity when
                  the cluster carries per-device traces (default True).
    """

    name = "carbon-aware"

    def __init__(self, budget_s: float = 60.0, *, headroom: float = 1.0,
                 trace: Optional[CarbonTrace] = None,
                 zone_aware: bool = True):
        super().__init__(budget_s, headroom=headroom)
        self.carbon_trace = trace
        self.zone_aware = zone_aware

    def set_carbon_trace(self, trace: CarbonTrace) -> None:
        """Bind the run's intensity trace (called by ``run_fleet``)."""
        self.carbon_trace = trace

    def _cold_score(self, model_id, t_s, cluster):
        base = self.carbon_trace
        per_dev = cluster.device_traces if self.zone_aware else {}
        # delegate to the joule score when no trace can change the
        # ranking: none bound anywhere, or one shared flat trace (a
        # flat trace scales every candidate by the same constant)
        distinct = {id(t): t for t in per_dev.values()}
        if base is not None:
            distinct.setdefault(id(base), base)
        traces = list(distinct.values())
        if not traces or (len(traces) == 1 and traces[0].is_flat):
            return super()._cold_score(model_id, t_s, cluster)
        gap = cluster.rates[model_id].expected_gap_s()

        def score(did: str) -> Tuple[float, str]:
            trace = per_dev.get(did) or base
            prof = cluster.devices[did].profile
            ld = cluster.loader_for(model_id, did)
            load_j = _above_base_load_j(cluster, model_id, did)
            step_w = marginal_park_w(cluster.devices[did],
                                     cluster.context_on(did))
            t_star = breakeven_seconds(ld, prof, paper_convention=False)
            t_load = ld.t_load_s
            t_warm = t_s + t_load             # the replica lands here
            load_now = (load_j / t_load) \
                * trace.integral(t_s, t_warm) / _J_PER_KWH \
                if t_load > 0 else 0.0
            park_through = step_w \
                * trace.integral(t_warm, t_warm + gap) / _J_PER_KWH
            park_then_reload = (
                step_w * trace.integral(t_warm, t_warm + min(gap, t_star))
                / _J_PER_KWH
                + load_j * trace.daily_mean_kg_per_kwh / _J_PER_KWH)
            wake_kg = 0.0
            if cluster.power_state(did) is PowerState.SLEEP:
                wake_kg = wake_cost_kg(cluster.devices[did], trace,
                                       t_s, t_warm, min(gap, t_star))
            return (load_now + wake_kg
                    + min(park_through, park_then_reload), did)

        return score


ROUTERS = {r.name: r for r in
           (WarmFirstRouter(), LeastLoadedRouter(), EnergyGreedyRouter(),
            BreakevenRouter(), SLOAwareRouter(), CarbonAwareRouter())}


def get_router(name: str) -> Router:
    """Look up a shared router instance by ``name`` (KeyError with the
    available names otherwise).  Instances are stateless across requests
    -- all adaptivity lives in the cluster's rate estimators -- so
    sharing them between runs is safe; ``run_fleet`` re-binds the carbon
    trace per run."""
    if name not in ROUTERS:
        raise KeyError(f"unknown router {name!r}; have {sorted(ROUTERS)}")
    return ROUTERS[name]


# ---------------------------------------------------------------------------
# Consolidation (placement pass).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Move:
    model_id: str
    src: str
    dst: str


class Consolidator:
    """Periodic packing pass: drain whole devices whose parked residents
    fit elsewhere, whenever the counterfactual saving beats the cost.

    Saving: without the migration the source keeps its context until its
    LAST armed idle timeout fires -- ``src dvfs_step_w * (last evict_at
    - now)``.  Cost: the above-bare migration load energy PLUS the
    destination-side context extension: the migrated replica re-arms a
    fresh timeout on the target, which can keep the target's (possibly
    larger) DVFS step up beyond the window its own residents had armed.
    All windows are capped at ``lookahead_s`` so always-on (infinite)
    timeouts compare finitely.  Draining is all-or-nothing per source
    device -- a partial move saves nothing, the source's context stays
    up for the models left behind.

    Carbon-aware mode (``carbon_aware=True``): identical plan structure
    and safety rules, but every power-x-window product in the benefit /
    cost comparison is integrated against the run's grid-intensity
    trace (kgCO2e instead of joules).  A migration burst in a trough
    that drains a context through the evening peak clears the margin
    earlier; the same migration proposed AT the peak is priced up and
    deferred -- consolidation work shifts into low-intensity windows.
    With a flat trace both sides scale by the same constant, so the
    decisions are exactly the energy decisions.  In a multi-zone fleet
    each window is priced at the owning device's LOCAL trace (source
    benefit at the source's zone, destination cost at the
    destination's), cross-zone moves pay the WAN checkpoint-transfer
    energy and its latency stretches the priced load window -- so
    consolidation also drifts parked models toward cleaner grids when
    the margin clears.

    Power gating (``gate_drained_devices=True``): the packing pass is
    what CREATES fully drained devices, so the same controller also
    decides when a drained device stops paying even ``p_base_w``: a
    device settled at bare for at least ``gate_margin x T*_gate``
    (``power_states.gate_breakeven_s`` -- the device-level ski rental:
    one wake cycle's extra energy over the bare-minus-sleep saving
    rate) is put to SLEEP.  Waiting out T*_gate before gating is the
    classic 2-competitive rent-then-buy rule: whatever the adversarial
    next placement does, the realized cost is at most twice the
    clairvoyant's.  Routers price the wake (latency + energy) into cold
    placement, so gated devices are only woken when genuinely worth it.

    Args:
      period_s:     planning cadence (sim seconds).
      margin:       require benefit >= margin * cost.
      lookahead_s:  cap on every counted window.
      carbon_aware: price benefit/cost in kgCO2e over the bound trace
                    (``run_fleet`` binds ``set_carbon_trace``).
      gate_drained_devices: put bare-idle devices to SLEEP once their
                    idle exceeds the gating breakeven (off by default:
                    every pre-gating result is bit-identical).
      gate_margin:  gate after ``gate_margin x T*_gate`` of bare idle.
    """

    def __init__(self, *, period_s: float = 900.0, margin: float = 1.0,
                 lookahead_s: float = 2 * 3600.0,
                 carbon_aware: bool = False,
                 gate_drained_devices: bool = False,
                 gate_margin: float = 1.0):
        if period_s <= 0:
            raise ValueError("period must be positive")
        if gate_margin <= 0:
            raise ValueError("gate margin must be positive")
        self.period_s = period_s
        self.margin = margin     # require benefit >= margin * cost
        self.lookahead_s = lookahead_s
        self.carbon_aware = carbon_aware
        self.gate_drained_devices = gate_drained_devices
        self.gate_margin = gate_margin
        self.carbon_trace: Optional[CarbonTrace] = None

    def set_carbon_trace(self, trace: CarbonTrace) -> None:
        """Bind the run's intensity trace (called by ``run_fleet``);
        only consulted when ``carbon_aware`` is set."""
        self.carbon_trace = trace

    def plan(self, cluster: Cluster, now_s: float,
             busy: Optional[dict] = None) -> List[Move]:
        """Propose migrations; never increases instantaneous fleet idle
        power (targets are already context-on, sources fully drain).

        Args:
          cluster: live fleet state.
          now_s:   planning instant (sim seconds).
          busy:    device_id -> busy flag; busy devices are skipped on
                   both sides (never migrate under in-flight work).
        Returns: list of ``Move`` actions the event loop applies through
          the destination loader channels (racing requests re-checked
          there)."""
        busy = busy or {}
        free_slots = {did: cluster.free_slots(did)
                      for did in cluster.devices}
        free_vram = {did: cluster.free_vram_gb(did)
                     for did in cluster.devices}
        on = {did for did in cluster.devices if cluster.context_on(did)}

        # drain low-occupancy, high-step sources first
        sources = sorted(
            (did for did in on if not busy.get(did)),
            key=lambda did: (cluster.occupancy(did),
                             -cluster.devices[did].profile.dvfs_step_w, did))
        horizon = now_s + self.lookahead_s

        def cap(t: float) -> float:
            return min(t, horizon)

        def trace_of(did: str):
            """The trace pricing this device's windows in carbon mode:
            its zone-local trace when run_fleet bound per-device traces,
            else the scenario trace (single-zone fleets bind the same
            object everywhere, so decisions are bit-identical)."""
            if not self.carbon_aware:
                return None
            return cluster.device_traces.get(did) or self.carbon_trace

        def weigh(power_w: float, t0: float, t1: float, trace) -> float:
            """One benefit/cost term: power held over [t0, t1], in
            joules -- or kgCO2e (trace-integrated) in carbon mode.
            Both sides of the margin test use the same units, so the
            comparison is homogeneous either way."""
            if t1 <= t0:
                return 0.0
            if trace is None:
                return power_w * (t1 - t0)
            return trace.carbon_kg(power_w, t0, t1)

        def xfer_cost(model_id: str, src: str, dst: str, trace) -> float:
            """WAN checkpoint-shipping energy for a cross-zone move, in
            the margin test's units.  Its grid draw has no single zone
            or phase, so carbon mode prices it at the destination
            trace's daily mean (same convention as the router's
            eventual-reload term).  Zero within one zone."""
            _, xj = cluster.migration_transfer(model_id, src, dst)
            if xj == 0.0 or trace is None:
                return xj
            return xj * trace.daily_mean_kg_per_kwh / _J_PER_KWH

        # per-target context window: how long its OWN residents keep the
        # step up regardless of what we pack onto it
        win = {did: max((m.evict_at
                         for m in cluster.managers[did].models.values()
                         if m.resident), default=now_s)
               for did in cluster.devices}

        moves: List[Move] = []
        drained = set()
        for src in sources:
            mm = cluster.managers[src]
            residents = [m for m in mm.models.values() if m.resident]
            if not residents or any(m.loading for m in mm.models.values()):
                continue
            # autoscaler-held replicas are not packing fodder: the
            # controller paid their load to keep that capacity standing,
            # and a migration would strip the hold (the destination
            # re-arms a policy timeout) -- skip the device (drain is
            # all-or-nothing anyway)
            if any(m.held for m in residents):
                continue
            # counterfactual: src pays its step until the last armed
            # timeout fires (capped so always-on compares finitely)
            last_evict = max(m.evict_at for m in residents)
            # revoked devices (spot warning/outage) are never packing
            # targets -- capacity about to vanish, same as a drained
            # gate -- but a revoked SOURCE may still drain: moving its
            # residents out before the OFF lands is pure win
            targets = [did for did in
                       sorted(on - drained - {src} - cluster.revoked)
                       if not busy.get(did)]
            assignment: List[Move] = []
            cost_j = 0.0
            slots = dict(free_slots)
            vram = dict(free_vram)
            trial_win = dict(win)
            # loads serialize on each destination's queue; track when
            # each target frees up so multi-model drains are priced at
            # their real start/finish times, not all at `now`
            dst_free = {did: now_s for did in targets}
            last_start = now_s      # src keeps its step until the last
            ok = True               # resident unloads (migration start)
            for m in sorted(residents, key=lambda r: -r.vram_gb):
                placed = False
                for dst in sorted(targets,
                                  key=lambda d: (-vram[d], d)):
                    if slots[dst] >= 1 and vram[dst] >= m.vram_gb:
                        assignment.append(Move(m.model_id, src, dst))
                        ld = cluster.loader_for(m.model_id, dst)
                        dst_trace = trace_of(dst)
                        xfer_s, _ = cluster.migration_transfer(
                            m.model_id, src, dst)
                        t_start = dst_free[dst]
                        # cross-zone: the checkpoint ships over the WAN
                        # first, stretching the destination's load
                        # window exactly as start_migration will
                        t_done = t_start + xfer_s + ld.t_load_s
                        # above-bare load burst over its real window
                        # (joules: exactly above_base_load_j; carbon:
                        # the same watts against the trace)
                        p_above = max(
                            ld.p_load_w
                            - cluster.devices[dst].profile.p_base_w, 0.0)
                        cost_j += weigh(p_above, t_start, t_done,
                                        dst_trace)
                        cost_j += xfer_cost(m.model_id, src, dst,
                                            dst_trace)
                        # destination-side extension: the migrated
                        # replica re-arms on dst and may hold dst's step
                        # up past its own residents' window
                        dst_free[dst] = t_done
                        last_start = max(last_start, t_start)
                        timeout = cluster.preview_timeout_s(
                            m.model_id, dst, t_done)
                        armed_end = t_done + timeout
                        step_dst = cluster.devices[dst].profile.dvfs_step_w
                        cost_j += weigh(step_dst,
                                        cap(max(trial_win[dst], now_s)),
                                        cap(armed_end), dst_trace)
                        trial_win[dst] = max(trial_win[dst], armed_end)
                        slots[dst] -= 1
                        vram[dst] -= m.vram_gb
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if not ok or not assignment:
                continue
            # realized benefit starts when the LAST resident leaves src
            benefit_j = weigh(cluster.devices[src].profile.dvfs_step_w,
                              cap(last_start), cap(last_evict),
                              trace_of(src))
            if benefit_j >= self.margin * cost_j:
                moves.extend(assignment)
                drained.add(src)
                free_slots, free_vram = slots, vram
                win = trial_win
        return moves

    def plan_gating(self, cluster: Cluster, now_s: float,
                    busy: Optional[dict] = None) -> List[str]:
        """Devices to put to SLEEP now (empty unless
        ``gate_drained_devices``): settled at bare, no runtime work, and
        bare-idle at least ``gate_margin x T*_gate`` (the device-level
        ski rental -- see the class docstring).  The event loop applies
        each through ``Cluster.gate_device``, which re-checks safety."""
        if not self.gate_drained_devices:
            return []
        busy = busy or {}
        out: List[str] = []
        for did in sorted(cluster.devices):
            if busy.get(did) or did in cluster.revoked:
                continue       # revoked: about to go OFF, gating is moot
            if cluster.power_state(did) is not PowerState.BARE:
                continue
            if cluster.occupancy(did) > 0:
                continue
            t_gate = gate_breakeven_s(cluster.devices[did].profile)
            if not math.isfinite(t_gate):
                continue
            if cluster.bare_idle_s(did, now_s) >= self.gate_margin * t_gate:
                out.append(did)
        return out
