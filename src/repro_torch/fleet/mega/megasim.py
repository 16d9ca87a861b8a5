"""Vectorized mega-fleet simulator: the event loop's exact dynamics in
array-program form, for 500-5000-device multi-million-request days.

``fleetsim.run_fleet`` walks one heap event per request; at mega scale
(millions of arrivals) the per-event Python overhead dominates.
``run_mega`` keeps a heap, but only for STRUCTURAL events -- load
completions and armed idle-timeout evictions -- and retires the
per-request work in bulk:

  * Device state lives in numpy vectors (occupied slots, VRAM, power
    state, watts) so least-loaded placement is one masked ``lexsort``
    instead of a min() over Python objects.
  * A model whose stream is in the common steady state -- exactly one
    warm replica, no load in flight or queued -- enters a WARM RUN: the
    maximal prefix of its remaining arrivals whose inter-arrival gaps
    are all <= the replica's idle timeout T is claimed in O(log n) via a
    precomputed big-gap index (``np.flatnonzero(np.diff(arr) > T)``),
    one eviction event is armed at ``arr[last] + T``, and the requests
    are committed lazily when the run ends.  Interruptions (capacity
    evictions from another model's load) commit the served prefix by
    ``searchsorted`` -- never by iterating requests.
  * A load in flight with no other replica absorbs every arrival before
    its completion straight into the wait queue (one slice), exactly the
    event loop's route-to-loading-device behaviour.
  * Energy is integrated per device as (state-interval dt) x (watts)
    only at actual power CHANGES, which is precisely what the event
    loop's ``EnergyMeter`` coalesces its timeline down to -- so the
    metered power segments come out float-identical and per-state Wh
    agrees to float-summation order.

Correctness spine (the repo's equivalence-anchor discipline,
docs/ARCHITECTURE.md): on the pinned 10-model x 6-GPU seed-100 day,
``run_mega`` reproduces ``run_fleet``'s request count and cold starts
EXACTLY and total/per-state Wh to float-summation precision (pinned in
``tests/test_mega.py`` far inside a 1e-3 relative budget).

Scope: the fast path covers the paper's evaluation convention --
warm-first routing, zero service time, no consolidator/autoscaler, and
constant-timeout eviction policies (AlwaysOn / FixedTTL / Breakeven /
CarbonBreakeven on a flat trace...).  Anything else raises
``MegaUnsupportedError`` so callers fall back to ``run_fleet`` instead
of silently diverging; the probe is behavioural (timeout sampled at
several instants, arrival hook checked for statefulness), not a class
allowlist.
"""
from __future__ import annotations

import functools
import heapq
import itertools
import math
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.coldstart import loader_from_checkpoint
from repro_torch.core.power_states import PowerState, state_power_w
from repro_torch.core.scheduler import Policy
from repro_torch.fleet.carbon import carbon_timeline_kg, carbon_timeline_multi_kg
from repro_torch.fleet.catalog import (carbon_kg, energy_cost_usd,
                                 fleet_price_usd, get_mix)
from repro_torch.fleet.cluster import _make_policy
from repro_torch.fleet.fleetsim import (DeviceReport, FleetResult, FleetScenario,
                                  clairvoyant_bound, zone_decomposition)
from repro_torch.fleet.pricing import (device_tier_map, price_fleet,
                                 tier_billed_seconds)
from repro_torch.fleet.router import WarmFirstRouter
from repro_torch.serving.service_model import ConstantServiceTime

# compact power-state codes for the three states a non-gated zero-service
# run can occupy; indices double as wire names via _STATE_KEYS
_BARE, _PARKED, _LOADING = 0, 1, 2
_STATE_KEYS = (PowerState.BARE.value, PowerState.CTX_IDLE.value,
               PowerState.LOADING.value)

# heap phases at equal timestamps, matching run_fleet's ordering
# (completions < arrivals) plus evictions AFTER everything -- the event
# loop's advance_to fires a deadline strictly BEFORE the next event's
# time, so a deadline equal to an event time must lose to that event
_P_DONE, _P_ARR, _P_EVICT = 0, 3, 4

_PROBE_TIMES = (0.0, 12345.678, 67801.25)


class MegaUnsupportedError(ValueError):
    """The scenario needs dynamics outside run_mega's vectorized scope
    (stateful policies, service time, consolidation, autoscaling, or a
    non-warm-first router).  Fall back to ``fleetsim.run_fleet``."""


def _probe_constant_timeout(policy) -> float:
    """Behavioural check that a policy is a constant idle timeout.

    Samples ``idle_timeout_s`` at several instants, and -- when the
    policy overrides the base no-op ``observe_arrival`` (duck-typed
    policies like CarbonBreakeven define their own) -- feeds it probe
    arrivals and re-samples, so stateful estimators (AdaptiveBreakeven)
    and time-varying stopping rules (CarbonBreakeven on a shaped trace)
    are rejected rather than mis-simulated."""
    try:
        ts = [policy.idle_timeout_s(t) for t in _PROBE_TIMES]
    except Exception as exc:
        raise MegaUnsupportedError(
            f"policy {getattr(policy, 'name', policy)!r} needs per-gap "
            f"context ({exc}); run_mega supports constant timeouts only"
        ) from exc
    base_hook = getattr(type(policy), "observe_arrival", None) \
        is Policy.observe_arrival
    if not base_hook:
        policy.observe_arrival(_PROBE_TIMES[0])
        policy.observe_arrival(_PROBE_TIMES[1])
        if [policy.idle_timeout_s(t) for t in _PROBE_TIMES] != ts:
            raise MegaUnsupportedError(
                f"policy {getattr(policy, 'name', policy)!r} adapts to "
                f"arrivals; run_mega supports constant timeouts only")
    if any(t != ts[0] for t in ts):
        raise MegaUnsupportedError(
            f"policy {getattr(policy, 'name', policy)!r} varies its "
            f"timeout over the day; run_mega supports constant timeouts")
    if not (ts[0] == math.inf or ts[0] > 0.0):
        raise MegaUnsupportedError(
            f"policy {getattr(policy, 'name', policy)!r} returned "
            f"non-positive timeout {ts[0]!r}")
    return float(ts[0])


class _Rep:
    """One (device, model) replica: the ManagedModel fields the mega
    dynamics need."""
    __slots__ = ("resident", "loading", "evict_at", "gen", "vram", "pos")

    def __init__(self, vram: float, pos: int):
        self.resident = False
        self.loading = False
        self.evict_at = math.inf
        self.gen = 0            # bumped on every (re)arm/evict: stale
        self.vram = vram        # eviction events carry the gen they saw
        self.pos = pos          # registration index on its device

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"_Rep(res={self.resident}, load={self.loading}, "
                f"evict_at={self.evict_at:g})")


class _BigGapCache:
    """Bounded LRU of derived per-stream arrays, shared across
    ``run_mega`` calls on the same ``FleetTrace``.

    Keyed by ``(id(arrivals), horizon)`` of the raw ``arrivals_s``
    object each ``FleetModel`` carries: a ``FleetTrace`` hands every
    ``to_scenario`` the SAME per-route arrays, so repeat runs (sweeps)
    hit.  An entry holds the sorted/horizon-filtered arrival array plus
    the stream's ``T -> big-gap index`` dict, so neither is rebuilt per
    run; a weakref to the source guards against ``id()`` reuse after
    gc.  Sources that cannot be weakly referenced (plain lists) are
    derived fresh each run -- the pre-cache behaviour.
    """

    def __init__(self, maxsize: int = 256, max_timeouts: int = 16):
        if maxsize < 1 or max_timeouts < 1:
            raise ValueError("cache bounds must be positive")
        self.maxsize = maxsize             # streams kept (LRU evicted)
        self.max_timeouts = max_timeouts   # per-stream biggap dict cap
        self.hits = 0
        self.misses = 0
        self._d: Dict[Tuple[int, float], tuple] = {}   # insertion = LRU

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = 0

    def stream_arrays(self, source, horizon: float
                      ) -> Tuple[np.ndarray, Dict[float, np.ndarray]]:
        """The (derived arrival array, shared biggap dict) for a raw
        ``arrivals_s`` object at a horizon, cached."""
        key = (id(source), float(horizon))
        ent = self._d.get(key)
        if ent is not None and ent[0]() is source:
            self.hits += 1
            self._d.pop(key)               # LRU bump
            self._d[key] = ent
            return ent[1], ent[2]
        self.misses += 1
        arr = np.sort(np.asarray(source, dtype=np.float64))
        arr = arr[(arr >= 0.0) & (arr < horizon)]
        biggap: Dict[float, np.ndarray] = {}
        try:
            ref = weakref.ref(source)
        except TypeError:
            return arr, biggap             # not weakly referenceable
        if ent is not None:
            self._d.pop(key, None)         # stale entry from id() reuse
        while len(self._d) >= self.maxsize:
            self._d.pop(next(iter(self._d)))
        self._d[key] = (ref, arr, biggap)
        return arr, biggap


biggap_cache = _BigGapCache()


class _Stream:
    """One model's arrival stream + replica-set bookkeeping."""
    __slots__ = ("mid", "arr", "n", "ptr", "ev", "res", "loading", "queued",
                 "waiters", "run_active", "run_dev", "run_last", "run_E0",
                 "suspended", "biggap")

    def __init__(self, mid: str, arr: np.ndarray,
                 biggap: Optional[Dict[float, np.ndarray]] = None):
        self.mid = mid
        self.arr = arr                   # sorted, within [0, horizon)
        self.n = int(arr.size)
        self.ptr = 0                     # next unconsumed arrival index
        self.ev = 0                      # arrival-event version (staleness)
        self.res: set = set()            # device indices with warm replica
        self.loading: set = set()        # device indices mid-load
        self.queued: set = set()         # queued-not-started loads
        self.waiters: Dict[int, list] = {}
        self.run_active = False
        self.run_dev = -1
        self.run_last = -1
        self.run_E0 = math.inf
        self.suspended = False           # arrivals pre-absorbed into a load
        # T -> big-gap indices; shared through biggap_cache so repeat
        # runs on the same FleetTrace reuse the scans
        self.biggap: Dict[float, np.ndarray] = \
            {} if biggap is None else biggap

    def biggaps(self, T: float) -> np.ndarray:
        """Indices i with arr[i+1] - arr[i] > T (a warm run starting at
        or before i ends at i).  Cached per distinct timeout (timeouts
        differ per SKU, not per device, so this stays tiny), bounded at
        ``biggap_cache.max_timeouts`` oldest-out."""
        got = self.biggap.get(T)
        if got is None:
            if math.isinf(T):
                got = np.empty(0, dtype=np.int64)
            else:
                got = np.flatnonzero(np.diff(self.arr) > T)
            if len(self.biggap) >= biggap_cache.max_timeouts:
                self.biggap.pop(next(iter(self.biggap)))
            self.biggap[T] = got
        return got


class _Fin:
    """What a bulk backend hands back at finalize time."""
    __slots__ = ("energy_j", "dur_s", "waits", "carbon_dev",
                 "carbon_timeline", "timings", "tier_billed_s")

    def __init__(self, energy_j, dur_s, waits, carbon_dev, carbon_timeline,
                 timings, tier_billed_s=None):
        self.energy_j = energy_j           # [N][3] joules per state
        self.dur_s = dur_s                 # [N][3] seconds per state
        self.waits = waits                 # per-request waits, any order
        self.carbon_dev = carbon_dev       # [N] kgCO2e
        self.carbon_timeline = carbon_timeline
        self.timings = timings             # phase -> wall seconds
        # tier -> billed seconds when the backend fused it into the
        # metering pass; None -> run_mega re-derives it from reports
        self.tier_billed_s = tier_billed_s


class _NumpyBulk:
    """The reference bulk backend: the exact inline numpy/Python paths
    the simulator shipped with (the bit-exact anchor vs ``run_fleet``),
    instrumented with per-phase wall-clock so the compiled backend's
    bulk-scan speedup is measured like-for-like.

    The seam: the event loop owns all STRUCTURAL state (heap, replica
    sets, pointers) and calls the backend for every bulk operation --
    energy charging, waiter billing, big-gap run claiming, and the
    finalize pass (carbon integration, waits assembly).  Both backends
    see identical calls in identical order, so every control-flow
    decision (routing tie-breaks, run extents) is backend-invariant by
    construction; only the arithmetic engine differs.
    """

    name = "numpy"
    wants_tables = False

    def __init__(self, n_dev: int):
        self.energy_j = [[0.0, 0.0, 0.0] for _ in range(n_dev)]
        self.dur_s = [[0.0, 0.0, 0.0] for _ in range(n_dev)]
        self.waits: List[float] = []
        self.t = {"biggap_s": 0.0, "billing_s": 0.0, "energy_s": 0.0,
                  "carbon_s": 0.0}

    def prepare(self, streams, stream_Ts) -> None:
        pass

    def charge(self, d: int, s: int, dt: float, p: float,
               a: float = 0.0, b: float = 0.0) -> None:
        # a/b (the absolute interval) only feed the torch backend's fused
        # metering pass; the numpy buckets need just dt
        self.energy_j[d][s] += dt * p
        self.dur_s[d][s] += dt

    def last_of_run(self, ms: _Stream, T: float) -> int:
        t0 = time.perf_counter()
        big = ms.biggaps(T)
        j = int(np.searchsorted(big, ms.ptr))
        last = int(big[j]) if j < big.size else ms.n - 1
        self.t["biggap_s"] += time.perf_counter() - t0
        return last

    def absorb(self, ms: _Stream, d: int, lo: int, hi: int,
               t_done: float) -> None:
        t0 = time.perf_counter()
        ms.waiters.setdefault(d, []).extend(ms.arr[lo:hi].tolist())
        self.t["billing_s"] += time.perf_counter() - t0

    def wait_one(self, ms: _Stream, d: int, t: float) -> None:
        ms.waiters.setdefault(d, []).append(t)

    def waiter_count(self, ms: _Stream, d: int) -> int:
        return len(ms.waiters.get(d, ()))

    def drain(self, ms: _Stream, d: int, t: float) -> int:
        w = ms.waiters.pop(d, None)
        if not w:
            return 0
        t0 = time.perf_counter()
        self.waits.extend(t - a for a in w)
        self.t["billing_s"] += time.perf_counter() - t0
        return len(w)

    def finalize(self, segs, fleet_segments, trace, horizon: float,
                 dev_traces=None, tiers=None) -> _Fin:
        t0 = time.perf_counter()
        waits = np.asarray(self.waits, dtype=np.float64)
        self.t["billing_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if dev_traces is not None and any(tr is not trace
                                          for tr in dev_traces):
            # multi-zone fleet: each device integrates against its own
            # zone's trace; the fleet timeline folds the per-device
            # segments in the exact order fleet_segments concatenates
            carbon_dev = [tr.carbon_for_segments(s)
                          for tr, s in zip(dev_traces, segs)]
            timeline = carbon_timeline_multi_kg(
                [(tr, sg) for tr, s in zip(dev_traces, segs) for sg in s],
                end_s=horizon)
        else:
            carbon_dev = [trace.carbon_for_segments(s) for s in segs]
            timeline = carbon_timeline_kg(trace, fleet_segments,
                                          end_s=horizon)
        self.t["carbon_s"] += time.perf_counter() - t0
        self.t["bulk_scan_s"] = sum(self.t.values())
        return _Fin(self.energy_j, self.dur_s, waits, carbon_dev, timeline,
                    dict(self.t))


def run_mega(scenario: FleetScenario, *,
             compute_bound: bool = True,
             backend: str = "torch",
             device: Optional[str] = None) -> FleetResult:
    """Vectorized replacement for ``run_fleet`` on its supported scope
    (see module docstring); raises ``MegaUnsupportedError`` otherwise.

    ``compute_bound=False`` skips the O(requests) clairvoyant-bound pass
    (reported as 0.0) -- the bound is a per-gap Python loop and would
    dominate wall-clock on multi-million-request days.

    ``backend`` selects the bulk-scan engine: ``"torch"`` (default)
    retires the bulk phases -- big-gap scans, deferred waiter billing,
    per-state energy segment-sums, and the carbon trapezoid integral --
    as PyTorch programs and hand-written CUDA kernels on ``device``
    (``fleet/mega/torchback.py``; ``None`` means ``"cuda"``, and a
    missing card raises ``RuntimeError`` rather than running on the
    CPU).  ``"numpy"`` is the bit-exact anchor vs ``run_fleet``.  Both
    backends drive the identical structural event loop, so request
    counts and cold starts are equal, per-(device, state) energy and
    seconds are bit-equal, and carbon totals agree to <=1e-9 relative
    (pinned in tests).  ``FleetResult.phase_timings`` reports per-phase
    wall seconds for either backend.
    """
    sc = scenario
    if backend == "numpy":
        _Bulk = _NumpyBulk
    elif backend == "torch":
        from repro_torch.fleet.mega import torchback
        _Bulk = functools.partial(torchback._TorchBulk, device=device)
    else:
        raise ValueError(
            f"unknown backend {backend!r}: expected 'torch' or 'numpy'")
    # ---- scope guard ------------------------------------------------------
    if not (sc.router == "warm-first"
            or isinstance(sc.router, WarmFirstRouter)):
        raise MegaUnsupportedError(
            f"run_mega supports warm-first routing only, got {sc.router!r}")
    if sc.consolidator is not None:
        raise MegaUnsupportedError("run_mega does not support consolidation")
    if sc.autoscaler is not None:
        raise MegaUnsupportedError("run_mega does not support autoscaling")
    svc = sc.resolved_service_model()
    if not (isinstance(svc, ConstantServiceTime) and svc.service_s == 0.0):
        raise MegaUnsupportedError(
            "run_mega supports the zero-service-time convention only "
            f"(got {getattr(svc, 'name', svc)!r})")
    if sc.preemptions is not None and sc.preemptions.draw(
            sc.devices, sc.device_tiers(), sc.horizon_s):
        # guard on the DRAW, not the model: an all-on-demand plan under
        # a preemption model has no revocable devices and replays
        # exactly -- only actual fault events exceed the mega scope
        raise MegaUnsupportedError(
            "run_mega does not support spot preemption faults; "
            "fall back to run_fleet")
    if not sc.devices:
        raise ValueError("empty fleet")

    trace = sc.resolved_carbon_trace()
    horizon = float(sc.horizon_s)
    # per-device zone bindings (tentpole): accounting-only at mega scope
    # -- policies keep the SCENARIO trace (so the per-(model, SKU)
    # loader/timeout cache stays valid) and warm-first routing is
    # zone-blind, but every device's joules integrate against its own
    # zone's intensity.  Single-zone fleets bind the same trace object
    # everywhere, keeping the bit-exact anchor vs run_fleet.
    zones = sc.device_zones()
    dev_traces_by_id = sc.device_carbon_traces(trace)
    multi_zone = len(set(zones.values())) > 1

    # ---- device vectors (index = rank in sorted(instance_id), so integer
    # comparisons reproduce every instance-id string tie-break) ------------
    by_id = {d.instance_id: d for d in sc.devices}
    if len(by_id) != len(sc.devices):
        raise ValueError("duplicate instance_id in fleet")
    dids = sorted(by_id)
    devs = [by_id[i] for i in dids]
    N = len(devs)
    vcap = np.array([d.sku.vram_gb for d in devs], dtype=np.float64)
    scap = np.array([d.sku.slots for d in devs], dtype=np.int64)
    occ = np.zeros(N, dtype=np.int64)
    vused = np.zeros(N, dtype=np.float64)
    p_bare = [state_power_w(d.profile, PowerState.BARE) for d in devs]
    p_park = [state_power_w(d.profile, PowerState.CTX_IDLE) for d in devs]
    state = [_BARE] * N
    watts = [p_bare[d] for d in range(N)]
    since = [0.0] * N
    bulk = _Bulk(N)
    touched = [[False, False, False] for _ in range(N)]
    key_order: List[List[int]] = [[] for _ in range(N)]
    segs: List[List[Tuple[float, float, float]]] = [[] for _ in range(N)]
    res_count = [0] * N
    d_cold = [0] * N
    d_reqs = [0] * N
    dev_models: List[List[str]] = [[] for _ in range(N)]   # registration order
    act: List[set] = [set() for _ in range(N)]   # currently resident|loading

    def _touch(d: int, s: int) -> None:
        if not touched[d][s]:
            touched[d][s] = True
            key_order[d].append(s)

    def _trans(d: int, t: float, ns: int, w: float) -> None:
        """Charge the open interval into the current state's bucket and
        enter (ns, w) -- the EnergyMeter transition, minus the dt=0
        flushes the event loop performs (which change no joules and
        coalesce away in its timeline)."""
        s = state[d]
        t0 = since[d]
        dt = t - t0
        p = watts[d]
        bulk.charge(d, s, dt, p, t0, t)
        _touch(d, s)
        if dt > 0.0:
            sg = segs[d]
            if sg and sg[-1][1] == t0 and sg[-1][2] == p:
                sg[-1] = (sg[-1][0], t, p)
            else:
                sg.append((t0, t, p))
        state[d] = ns
        watts[d] = w
        since[d] = t

    def recompute_vused(d: int) -> None:
        """Fresh registration-order sum, so capacity comparisons see the
        exact float the event loop's ``vram_used_gb`` computes (an
        incremental add/subtract could drift in the last bits and flip a
        boundary ``fits`` decision).  Walks only the currently-contributing
        replicas (``act``), sorted back into registration order -- NOT all
        models ever registered on the device, which grows toward M over a
        long day and made this O(M * events)."""
        s = 0.0
        for m in sorted(act[d], key=lambda m: reps[(d, m)].pos):
            s += reps[(d, m)].vram
        vused[d] = s

    # ---- per-(model, SKU) constants: loader + probed constant timeout ----
    specs = {}
    for fm in sc.models:
        if fm.spec.model_id in specs:
            raise MegaUnsupportedError(
                f"duplicate model_id {fm.spec.model_id!r}: run_fleet would "
                f"merge their specs; run_mega refuses")
        specs[fm.spec.model_id] = fm.spec
    sku_of = [d.sku.key for d in devs]
    _per_sku: Dict[Tuple[str, str], Tuple[object, float]] = {}

    def _loader_T(mid: str, d: int):
        key = (mid, sku_of[d])
        got = _per_sku.get(key)
        if got is None:
            spec = specs[mid]
            if spec.loader is not None:
                loader = spec.loader
            else:
                loader = loader_from_checkpoint(
                    mid, spec.checkpoint_bytes, devs[d].profile)
            policy = _make_policy(spec.policy_factory, loader,
                                  devs[d].profile, trace)
            got = (loader, _probe_constant_timeout(policy))
            _per_sku[key] = got
        return got

    # ---- streams, replicas, heap -----------------------------------------
    streams: Dict[str, _Stream] = {}
    for fm in sc.models:
        a, shared_biggap = biggap_cache.stream_arrays(fm.arrivals_s,
                                                      horizon)
        streams[fm.spec.model_id] = _Stream(fm.spec.model_id, a,
                                            shared_biggap)
    if bulk.wants_tables:
        # candidate constant timeouts per stream: one probe per (model,
        # SKU present).  A probe failure is skipped, NOT raised -- the
        # numpy path probes lazily on first routing, so scope rejection
        # must surface at the same instant on either backend.
        rep_dev: Dict[str, int] = {}
        for i, k in enumerate(sku_of):
            rep_dev.setdefault(k, i)
        stream_Ts: Dict[str, List[float]] = {}
        for mid in streams:
            Ts: List[float] = []
            for d0 in rep_dev.values():
                try:
                    T = _loader_T(mid, d0)[1]
                except MegaUnsupportedError:
                    continue
                if T not in Ts:
                    Ts.append(T)
            stream_Ts[mid] = Ts
        bulk.prepare(streams, stream_Ts)

    reps: Dict[Tuple[int, str], _Rep] = {}

    def get_rep(d: int, mid: str) -> _Rep:
        rep = reps.get((d, mid))
        if rep is None:
            rep = _Rep(specs[mid].vram_gb, len(dev_models[d]))
            reps[(d, mid)] = rep
            dev_models[d].append(mid)
        return rep

    heap: list = []
    seq = itertools.count()
    n_live = 0                  # pending arrival + load_done heap entries
    n_zero = 0                  # warm-served requests (zero added latency)
    replica_log: Dict[str, List[Tuple[float, int]]] = {}
    inflight: List[Optional[str]] = [None] * N     # loader channel
    dq = [deque() for _ in range(N)]               # queued loads (FIFO)
    dq_set: List[set] = [set() for _ in range(N)]

    def push(t: float, phase: int, payload: tuple) -> None:
        heapq.heappush(heap, (t, phase, next(seq), payload))

    def push_arr(ms: _Stream) -> None:
        nonlocal n_live
        ms.ev += 1              # at most ONE valid arrival event per stream
        push(float(ms.arr[ms.ptr]), _P_ARR, (ms.mid, ms.ptr, ms.ev))
        n_live += 1

    def log_replicas(ms: _Stream, t: float) -> None:
        log = replica_log[ms.mid]
        n = len(ms.res)
        if not log or log[-1][1] != n:
            log.append((t, n))

    def arm(d: int, mid: str, t: float) -> None:
        rep = reps[(d, mid)]
        rep.gen += 1
        T = _loader_T(mid, d)[1]
        if math.isinf(T):
            rep.evict_at = math.inf
        else:
            rep.evict_at = t + T
            push(rep.evict_at, _P_EVICT, (d, mid, rep.gen))

    def cur_evict_at(d: int, mid: str, t: float) -> float:
        """The deadline the event loop would see at instant t -- for a
        replica mid-run, that is the last run arrival before t plus its
        timeout (each warm hit re-arms), reconstructed lazily."""
        ms = streams[mid]
        if ms.run_active and ms.run_dev == d:
            k = int(np.searchsorted(ms.arr, t, "left"))
            k = min(k, ms.run_last + 1)
            if k <= ms.ptr:
                return ms.run_E0
            return float(ms.arr[k - 1]) + _loader_T(mid, d)[1]
        return reps[(d, mid)].evict_at

    def evict_replica(d: int, mid: str, t: float) -> None:
        """Unload now (idle timeout fired, or make_room pressure).  A
        replica mid-run first commits its served prefix (arrivals
        strictly before t were warm hits)."""
        nonlocal n_zero
        rep = reps[(d, mid)]
        ms = streams[mid]
        if ms.run_active and ms.run_dev == d:
            k = int(np.searchsorted(ms.arr, t, "left"))
            k = min(max(k, ms.ptr), ms.run_last + 1)
            served = k - ms.ptr
            d_reqs[d] += served
            n_zero += served
            ms.ptr = k
            ms.run_active = False
        rep.resident = False
        rep.evict_at = math.inf
        rep.gen += 1
        act[d].discard(mid)
        ms.res.discard(d)
        occ[d] -= 1
        res_count[d] -= 1
        recompute_vused(d)
        log_replicas(ms, t)
        if res_count[d] == 0 and state[d] == _PARKED:
            _trans(d, t, _BARE, p_bare[d])
        if ms.ptr < ms.n and not ms.suspended:
            push_arr(ms)        # stream continues cold (or on other replicas)

    def make_room(d: int, mid_new: str, t: float) -> None:
        need = specs[mid_new].vram_gb

        def over() -> bool:
            return (vused[d] + need > vcap[d] or occ[d] + 1 > scap[d])

        if not over():
            return
        # the event loop scans its models dict (registration order) and
        # stable-sorts by deadline -- reproduce that from the small active
        # set: registration order first, then a stable deadline sort
        victims = sorted((m for m in act[d]
                          if m != mid_new and reps[(d, m)].resident),
                         key=lambda m: reps[(d, m)].pos)
        victims.sort(key=lambda m: cur_evict_at(d, m, t))
        for m in victims:
            if not over():
                break
            evict_replica(d, m, t)

    def least_loaded(mid: str) -> int:
        # lexicographic argmin of (occ, -free_vram, index) without a full
        # sort: staged boolean masks, O(N) per call on the cold-route path
        need = specs[mid].vram_gb
        free_v = vcap - vused
        cand = np.flatnonzero((scap - occ >= 1) & (free_v >= need))
        if cand.size == 0:
            cand = np.arange(N)
        o = occ[cand]
        cand = cand[o == o.min()]
        f = free_v[cand]
        return int(cand[f == f.max()][0])

    def start_load(d: int, ms: _Stream, t: float) -> None:
        nonlocal n_live
        rep = get_rep(d, ms.mid)
        make_room(d, ms.mid, t)
        rep.loading = True
        act[d].add(ms.mid)
        ms.loading.add(d)
        occ[d] += 1
        recompute_vused(d)
        loader = _loader_T(ms.mid, d)[0]
        _trans(d, t, _LOADING, loader.p_load_w)
        t_done = t + loader.t_load_s
        push(t_done, _P_DONE, (d, ms.mid))
        n_live += 1
        # the only replica coming up: every arrival before t_done routes
        # warm-first to this loading replica and waits -- absorb them in
        # one slice instead of one heap event each
        if (not ms.res and ms.loading == {d} and not ms.queued
                and ms.ptr < ms.n):
            k = int(np.searchsorted(ms.arr, t_done, "left"))
            if k > ms.ptr:
                bulk.absorb(ms, d, ms.ptr, k, t_done)
                ms.ptr = k
            ms.suspended = True

    def pump(d: int, t: float) -> None:
        """Start the next queued load if the serialized channel is free
        (run_fleet's pump_loader, minus migrations/wakes)."""
        if inflight[d] is not None:
            return
        q = dq[d]
        while q:
            mid = q.popleft()
            dq_set[d].discard(mid)
            ms = streams[mid]
            ms.queued.discard(d)
            rep = reps.get((d, mid))
            if rep is not None and (rep.resident or rep.loading):
                continue        # a racing load landed it meanwhile
            inflight[d] = mid
            start_load(d, ms, t)
            return

    def continue_stream(ms: _Stream) -> None:
        """Re-plan a stream after its replica set settled: enter a bulk
        warm run when the steady single-replica state holds, otherwise
        fall back to one heap event for the next arrival."""
        ms.suspended = False
        if ms.ptr >= ms.n:
            return
        if len(ms.res) == 1 and not ms.loading and not ms.queued:
            d = next(iter(ms.res))
            rep = reps[(d, ms.mid)]
            if float(ms.arr[ms.ptr]) > rep.evict_at:
                return          # idle gap: the armed eviction restarts us
            T = _loader_T(ms.mid, d)[1]
            last = bulk.last_of_run(ms, T)
            ms.run_active = True
            ms.run_dev = d
            ms.run_last = last
            ms.run_E0 = rep.evict_at
            arm(d, ms.mid, float(ms.arr[last]))
        else:
            push_arr(ms)

    def drain_waiters(d: int, ms: _Stream, t: float) -> None:
        d_reqs[d] += bulk.drain(ms, d, t)

    def on_load_done(t: float, d: int, mid: str) -> None:
        inflight[d] = None
        ms = streams[mid]
        rep = reps[(d, mid)]
        rep.loading = False
        rep.resident = True
        ms.loading.discard(d)
        ms.res.add(d)
        res_count[d] += 1
        recompute_vused(d)
        d_cold[d] += 1
        _trans(d, t, _PARKED, p_park[d])
        if ms.run_active:       # defensive: a run elsewhere cannot coexist
            nonlocal n_zero     # with a load in mega scope, but commit it
            k = int(np.searchsorted(ms.arr, t, "left"))
            k = min(max(k, ms.ptr), ms.run_last + 1)
            d_reqs[ms.run_dev] += k - ms.ptr
            n_zero += k - ms.ptr
            ms.ptr = k
            ms.run_active = False
        arm(d, mid, t)
        drain_waiters(d, ms, t)
        log_replicas(ms, t)
        pump(d, t)
        continue_stream(ms)

    def on_arrival(t: float, mid: str, idx: int, ev: int) -> None:
        nonlocal n_zero
        ms = streams[mid]
        if ev != ms.ev or idx != ms.ptr:
            return              # superseded by an absorb / run / re-push
        ms.ptr += 1
        locs = ms.res | ms.loading
        if locs:
            # warm-first: least-pressure warm replica; a mid-load replica
            # counts as a full pool so residency wins ties
            d = min(locs, key=lambda x: (bulk.waiter_count(ms, x),
                                         0 if x in ms.res else 1, x))
            if d in ms.res:
                d_reqs[d] += 1
                n_zero += 1
                if state[d] == _LOADING:
                    # run_fleet's settle-then-recompose flush creates the
                    # parked bucket (0 Wh) on a device serving a warm hit
                    # mid-another-model's-load; mirror the touched keys
                    _touch(d, _LOADING)
                    _touch(d, _PARKED)
                arm(d, mid, t)
                continue_stream(ms)
            else:
                bulk.wait_one(ms, d, t)
                if ms.ptr < ms.n and not ms.suspended:
                    push_arr(ms)
            return
        # cold: least-loaded placement, queue the load on that device's
        # serialized channel (dedup while queued or in flight)
        d = least_loaded(mid)
        rep = get_rep(d, mid)
        bulk.wait_one(ms, d, t)
        if not rep.loading and mid not in dq_set[d]:
            dq_set[d].add(mid)
            dq[d].append(mid)
            ms.queued.add(d)
            pump(d, t)
        if ms.ptr < ms.n and not ms.suspended:
            push_arr(ms)

    # ---- prewarm (run_fleet's Table-6 warm-start convention) --------------
    idx_of = {did: i for i, did in enumerate(dids)}
    for fm in sc.models:
        mid = fm.spec.model_id
        replica_log.setdefault(mid, [])
        if fm.spec.home is None:
            continue
        d = idx_of[fm.spec.home]
        need = fm.spec.vram_gb
        if not (scap[d] - occ[d] >= 1 and vcap[d] - vused[d] >= need):
            fitting = np.flatnonzero((scap - occ >= 1)
                                     & (vcap - vused >= need))
            if fitting.size == 0:
                continue        # starts cold
            free_v = vcap[fitting] - vused[fitting]
            order = np.lexsort((fitting, -free_v, occ[fitting]))
            d = int(fitting[order[0]])
        rep = get_rep(d, mid)
        rep.resident = True
        act[d].add(mid)
        occ[d] += 1
        res_count[d] += 1
        recompute_vused(d)
        d_cold[d] += 1
        streams[mid].res.add(d)
        _trans(d, 0.0, _PARKED, p_park[d])
        arm(d, mid, 0.0)
    for fm in sc.models:        # timeline origin, including zero-replica
        ms = streams[fm.spec.model_id]
        replica_log[ms.mid].append((0.0, len(ms.res)))
    for fm in sc.models:        # kick every stream
        ms = streams[fm.spec.model_id]
        if ms.n == 0:
            continue
        if ms.res:
            continue_stream(ms)
        else:
            push_arr(ms)

    # ---- main loop: structural events only --------------------------------
    last_done_t = 0.0
    deferred: List[Tuple[float, int, str, int]] = []
    while heap:
        t, phase, _s, payload = heapq.heappop(heap)
        if phase == _P_EVICT:
            d, mid, gen = payload
            rep = reps.get((d, mid))
            if rep is None or not rep.resident or rep.gen != gen:
                continue
            if t < horizon or n_live > 0:
                # some later event (all remaining real events are strictly
                # later) or the final advance-to-horizon will cross this
                # deadline, so the event loop fires it at exactly t
                evict_replica(d, mid, t)
            else:
                # past the horizon with nothing left in flight: fires only
                # if the final clock (a load may overshoot) passes it
                deferred.append((t, d, mid, gen))
            continue
        n_live -= 1
        if phase == _P_ARR:
            mid, idx, ev = payload
            on_arrival(t, mid, idx, ev)
        else:
            d, mid = payload
            last_done_t = max(last_done_t, t)
            on_load_done(t, d, mid)

    # arrivals all land before the horizon; only a load can overshoot it
    final_clock = max(horizon, last_done_t)
    for t, d, mid, gen in deferred:
        rep = reps.get((d, mid))
        if (rep is not None and rep.resident and rep.gen == gen
                and t < final_clock):
            evict_replica(d, mid, t)

    # commit runs still warm at the end (their eviction deadline lies at
    # or beyond the final clock, so every claimed arrival was served)
    for ms in streams.values():
        if ms.run_active:
            served = ms.run_last + 1 - ms.ptr
            d_reqs[ms.run_dev] += served
            n_zero += served
            ms.ptr = ms.run_last + 1
            ms.run_active = False
        if ms.ptr != ms.n or ms.waiters:
            raise RuntimeError(
                f"mega invariant violated: stream {ms.mid!r} left "
                f"{ms.n - ms.ptr} arrivals unserved")
    for d in range(N):
        _trans(d, final_clock, state[d], watts[d])   # totals() flush

    # ---- bulk finalize: billing, energy buckets, carbon integration ------
    fleet_segments: List[Tuple[float, float, float]] = []
    for d in range(N):
        fleet_segments.extend(segs[d])
    dev_trace_list = [dev_traces_by_id[did] for did in dids]
    tiers_map = device_tier_map(sc.devices, sc.price_tier)
    fin = bulk.finalize(segs, fleet_segments, trace, horizon,
                        dev_trace_list,
                        tiers=[tiers_map[did] for did in dids])
    energy_j = fin.energy_j
    dur_s = fin.dur_s

    # ---- reports (same construction as run_fleet) -------------------------
    reports = []
    for d in range(N):
        e_wh = {_STATE_KEYS[s]: energy_j[d][s] / 3600.0
                for s in key_order[d]}
        e_wh["total"] = sum(e_wh.values())
        durations = {_STATE_KEYS[s]: dur_s[d][s] for s in key_order[d]}
        reports.append(DeviceReport(
            instance_id=dids[d], sku=devs[d].sku.key,
            energy_wh=e_wh,
            parking_tax_wh=(dur_s[d][_PARKED]
                            * devs[d].profile.dvfs_step_w / 3600.0),
            cold_starts=d_cold[d], requests=d_reqs[d],
            resident=[m for m in dev_models[d] if reps[(d, m)].resident],
            meter_state=_STATE_KEYS[state[d]],
            carbon_kg=fin.carbon_dev[d],
            zone=zones[dids[d]],
            durations_s=durations))

    if compute_bound:
        lb_nongated, cv_sum = clairvoyant_bound(sc)
    else:
        lb_nongated = cv_sum = 0.0
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
        # same per-zone pricing as run_fleet's multi-zone branch
        energy_usd = math.fsum(
            energy_cost_usd(wh, get_mix(z)) for z, wh in zone_wh.items())
        kg_flat = math.fsum(
            carbon_kg(wh, get_mix(z)) for z, wh in zone_wh.items())
    else:
        energy_usd = energy_cost_usd(energy, mix)
        kg_flat = carbon_kg(energy, mix)
    cost = price_fleet(sc.devices, reports, default_tier=sc.price_tier,
                       energy_usd=energy_usd)
    tier_billed = (fin.tier_billed_s if fin.tier_billed_s is not None
                   else tier_billed_seconds(sc.devices, reports,
                                            sc.price_tier))
    all_lat = np.concatenate([np.zeros(n_zero), fin.waits])
    return FleetResult(
        router="warm-first", horizon_s=horizon, devices=reports,
        energy_wh=energy,
        parking_tax_wh=sum(r.parking_tax_wh for r in reports),
        cold_starts=sum(d_cold), requests=sum(d_reqs),
        added_latency_s_total=math.fsum(fin.waits),
        migrations=0,
        lb_nongated_wh=lb_nongated, cv_per_model_wh=cv_sum,
        infra_usd=fleet_price_usd(sc.devices, horizon, sc.price_tier),
        energy_usd=energy_usd,
        carbon_kg=math.fsum(r.carbon_kg for r in reports),
        carbon_kg_flat=kg_flat,
        carbon_trace_name=trace.name,
        carbon_timeline=fin.carbon_timeline,
        power_timeline=fleet_segments,
        zone_energy_wh=zone_wh, zone_carbon_kg=zone_kg,
        latencies_s=np.sort(all_lat),
        replica_timeline={mid: list(log)
                          for mid, log in replica_log.items()},
        state_energy_wh=state_wh, state_durations_s=state_s,
        phase_timings=fin.timings,
        cost_usd=cost.cost_usd, gpu_hours_usd=cost.gpu_hours_usd,
        device_gpu_usd=cost.device_gpu_usd,
        device_cost_usd=cost.device_cost_usd,
        zone_cost_usd=cost.zone_cost_usd, device_tiers=cost.device_tiers,
        tier_billed_s=tier_billed)
