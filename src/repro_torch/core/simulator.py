"""24-hour keep-warm/evict energy simulation (paper section 7, Table 6).

Event-driven walk over an arrival trace for ONE model on ONE device.
Power accounting follows the paper's Table 6 convention exactly:

  * warm idle   : P_ctx            (context-active idle)
  * evicted     : P_base           (bare idle -- the chip does not power off)
  * loading     : P_load           (loader-specific burst)
  * serving     : P_ctx (+active power only if service_s > 0; the paper's
                  evaluation holds request service energy constant across
                  policies, so Always-On 24 h energy == P_ctx * 24 h)

Always-on therefore integrates to P_ctx * horizon, matching the paper's
2,921 Wh baseline for the H100 (121.7 W x 24 h).

Cold-start latency: a request arriving while evicted waits t_load; a
request arriving mid-load or mid-service waits the residual time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.coldstart import LoaderSpec
from repro_torch.core.power_model import DeviceProfile
from repro_torch.core.power_states import (PowerState, PowerStateMachine,
                                     state_power_w)
from repro_torch.core.scheduler import Policy


@dataclasses.dataclass
class SimResult:
    policy: str
    horizon_s: float
    n_requests: int
    energy_wh: float
    cold_starts: int
    warm_idle_s: float
    evicted_s: float
    loading_s: float
    added_latency_s_total: float

    @property
    def mean_added_latency_s(self) -> float:
        return (self.added_latency_s_total / self.n_requests
                if self.n_requests else 0.0)

    def savings_vs(self, baseline: "SimResult") -> float:
        return 1.0 - self.energy_wh / baseline.energy_wh


def simulate(
    arrivals_s: Sequence[float],
    policy: Policy,
    profile: DeviceProfile,
    loader: LoaderSpec,
    *,
    horizon_s: float = 24 * 3600.0,
    service_s: float = 0.0,
    service_util: float = 0.6,
    start_warm: bool = True,
) -> SimResult:
    """Run one (trace, policy) cell of the paper's Table 6."""
    arrivals = sorted(float(a) for a in arrivals_s if 0.0 <= a < horizon_s)
    policy.reset()

    energy_j = 0.0
    warm_idle_s = evicted_s = loading_s = 0.0
    latency_s = 0.0
    cold_starts = 1 if start_warm else 0   # initial load (paper counts 1)

    # per-state power from the shared state machine (power_states): the
    # same formula the serving EnergyMeter integrates, so the layers
    # cannot drift apart
    p_ctx = state_power_w(profile, PowerState.CTX_IDLE)
    p_base = state_power_w(profile, PowerState.BARE)
    p_load = state_power_w(profile, PowerState.LOADING, loader)
    t_load = loader.t_load_s
    p_serve = state_power_w(profile, PowerState.ACTIVE,
                            service_util=service_util) \
        if service_s > 0 else p_ctx

    def spend(dt: float, watts: float) -> None:
        nonlocal energy_j
        if dt > 0:
            energy_j += dt * watts

    t = 0.0           # simulation clock: model is warm-idle at `t` if `warm`
    warm = start_warm
    # validated state walk alongside the closed-form integration: every
    # warm/evict/load edge below is a legal machine transition (a
    # miswired edge raises IllegalPowerTransition here, in the
    # REFERENCE dynamics, before any meter could misprice it)
    machine = PowerStateMachine(
        PowerState.CTX_IDLE if start_warm else PowerState.BARE, t)
    n = len(arrivals)
    i = 0
    while i < n:
        a = arrivals[i]
        policy.observe_arrival(a)
        gap = a - t
        if gap > 0:
            # --- idle interval [t, a) under the eviction policy -----------
            if warm:
                timeout = policy.idle_timeout_s(t, next_gap_s=gap)
                stay = min(gap, timeout)
                spend(stay, p_ctx)
                warm_idle_s += stay
                if stay < gap:            # evicted mid-gap
                    warm = False
                    machine.to(PowerState.BARE, t + stay)
                    spend(gap - stay, p_base)
                    evicted_s += gap - stay
            else:
                spend(gap, p_base)
                evicted_s += gap
        # gap <= 0 means the model is still busy from the previous batch;
        # the request queues (latency accounted below via ready time).
        ready = max(t, a)
        if not warm:
            # --- cold start -----------------------------------------------
            cold_starts += 1
            machine.to(PowerState.LOADING, ready)
            load_end = ready + t_load
            spend(t_load, p_load)
            loading_s += t_load
            warm = True
            machine.to(PowerState.CTX_IDLE, load_end)
            ready = load_end
        # serve this request plus anything that arrived before `ready`
        j = i
        while j < n and arrivals[j] <= ready:
            if j > i:
                policy.observe_arrival(arrivals[j])
            latency_s += ready - arrivals[j]
            j += 1
        batch = j - i
        if service_s > 0:
            machine.to(PowerState.ACTIVE, ready)
        spend(batch * service_s, p_serve)
        t = ready + batch * service_s
        if service_s > 0:
            machine.to(PowerState.CTX_IDLE, t)
        i = j

    # --- trailing interval [t, horizon) ----------------------------------
    gap = horizon_s - t
    if gap > 0:
        if warm:
            timeout = policy.idle_timeout_s(t, next_gap_s=gap)
            stay = min(gap, timeout)
            spend(stay, p_ctx)
            warm_idle_s += stay
            if stay < gap:
                machine.to(PowerState.BARE, t + stay)
                spend(gap - stay, p_base)
                evicted_s += gap - stay
        else:
            spend(gap, p_base)
            evicted_s += gap

    return SimResult(
        policy=policy.name,
        horizon_s=horizon_s,
        n_requests=n,
        energy_wh=energy_j / 3600.0,
        cold_starts=cold_starts,
        warm_idle_s=warm_idle_s,
        evicted_s=evicted_s,
        loading_s=loading_s,
        added_latency_s_total=latency_s,
    )


def compare_policies(
    arrivals_s: Sequence[float],
    policies: Sequence[Policy],
    profile: DeviceProfile,
    loader: LoaderSpec,
    **kw,
) -> List[SimResult]:
    """Table-6 style comparison; first policy is treated as the baseline."""
    return [simulate(arrivals_s, p, profile, loader, **kw) for p in policies]
