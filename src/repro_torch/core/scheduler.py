"""Keep-warm / evict policies (paper section 7 + beyond-paper extensions).

A policy answers one question after each service completion: *how long may
the model sit warm-idle before we evict it?*  (``math.inf`` = never evict.)

Paper policies:
  * AlwaysOn            -- industry default
  * FixedTTL(ttl)       -- evict after a fixed idle timeout
  * Breakeven           -- evict after T* = P_load * t_load / P_park (Eq. 12)

Beyond-paper policies (DESIGN.md section 2, "beyond paper"):
  * ExactBreakeven      -- energy-exact T* (charges only above-bare loading
                           power); strictly shorter T*, strictly >= savings
  * AdaptiveBreakeven   -- EWMA arrival-rate estimator + hysteresis band
                           around lambda* (Eq. 13).  Fixes the diurnal
                           oscillation the paper reports in section 8.
  * Clairvoyant         -- offline optimal (ski-rental with known gaps);
                           upper-bounds attainable savings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.breakeven import breakeven_seconds, critical_rate_per_hr
from repro_torch.core.coldstart import LoaderSpec
from repro_torch.core.power_model import DeviceProfile


class Policy:
    """Base class: stateful idle-timeout policies."""

    name = "base"
    clairvoyant = False

    def reset(self) -> None:  # called once per simulation
        pass

    def observe_arrival(self, t_s: float) -> None:
        """Called at every request arrival (for rate estimators)."""

    def idle_timeout_s(self, now_s: float, next_gap_s: Optional[float] = None
                       ) -> float:
        """Seconds of idle to tolerate before evicting; inf = keep warm."""
        raise NotImplementedError


class AlwaysOn(Policy):
    name = "always-on"

    def idle_timeout_s(self, now_s, next_gap_s=None) -> float:
        return math.inf


class FixedTTL(Policy):
    def __init__(self, ttl_s: float):
        if ttl_s <= 0:
            raise ValueError("ttl must be positive")
        self.ttl_s = float(ttl_s)
        self.name = f"ttl-{ttl_s / 60:g}min"

    def idle_timeout_s(self, now_s, next_gap_s=None) -> float:
        return self.ttl_s


class Breakeven(Policy):
    """Paper section 7 policy: evict after T* seconds of idle."""

    def __init__(self, loader: LoaderSpec, profile: DeviceProfile, *,
                 paper_convention: bool = True):
        self.t_star_s = breakeven_seconds(loader, profile,
                                          paper_convention=paper_convention)
        conv = "paper" if paper_convention else "exact"
        self.name = f"breakeven-{conv}(T*={self.t_star_s:.0f}s)"

    def idle_timeout_s(self, now_s, next_gap_s=None) -> float:
        return self.t_star_s


def ExactBreakeven(loader: LoaderSpec, profile: DeviceProfile) -> Breakeven:
    """Beyond-paper: energy-exact convention (see breakeven.py docstring)."""
    return Breakeven(loader, profile, paper_convention=False)


class AdaptiveBreakeven(Policy):
    """Beyond-paper: EWMA rate estimate + hysteresis around lambda*.

    Decision (Eq. 13): keep warm iff lambda_hat > lambda*.  A hysteresis
    band [lambda*(1-h), lambda*(1+h)] with sticky state kills the threshold
    oscillation near the crossover rate that makes plain Breakeven lose to
    TTL on diurnal ramps (paper Table 6 / section 8 discussion).
    When the estimate says evict, we still wait T* (the myopic optimum).
    """

    def __init__(self, loader: LoaderSpec, profile: DeviceProfile, *,
                 halflife_s: float = 900.0, hysteresis: float = 0.3,
                 keep_cap_tstars: float = 4.0, evict_frac_tstars: float = 0.0,
                 paper_convention: bool = True):
        self.t_star_s = breakeven_seconds(loader, profile,
                                          paper_convention=paper_convention)
        self.lambda_star_hr = critical_rate_per_hr(
            loader, profile, paper_convention=paper_convention)
        self.halflife_s = halflife_s
        self.h = hysteresis
        self.keep_cap = keep_cap_tstars
        self.evict_frac = evict_frac_tstars
        self.name = f"adaptive-breakeven(h={hysteresis:g})"
        self.reset()

    def reset(self) -> None:
        self._rate_hr: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._keep_warm = True          # start optimistic (model just loaded)

    def observe_arrival(self, t_s: float) -> None:
        if self._last_arrival is not None:
            gap = max(t_s - self._last_arrival, 1e-9)
            inst_rate_hr = 3600.0 / gap
            if self._rate_hr is None:
                self._rate_hr = inst_rate_hr
            else:
                # per-event EWMA with time-aware decay
                alpha = 1.0 - 0.5 ** (gap / self.halflife_s)
                self._rate_hr += alpha * (inst_rate_hr - self._rate_hr)
        self._last_arrival = t_s

    def idle_timeout_s(self, now_s, next_gap_s=None) -> float:
        confident = None
        if self._rate_hr is not None:
            if self._rate_hr > self.lambda_star_hr * (1.0 + self.h):
                self._keep_warm = True
                confident = True
            elif self._rate_hr < self.lambda_star_hr * (1.0 - self.h):
                self._keep_warm = False
                confident = True
            # inside the band: sticky previous decision (hysteresis)
        if self._keep_warm:
            # trust the estimator but cap exposure at keep_cap * T* in case
            # the burst has ended (the rate estimate is stale while idle)
            return self.keep_cap * self.t_star_s
        if confident:
            # Eq. 13: for memoryless arrivals below lambda* the optimal
            # action is to evict immediately (binary policy).
            return self.evict_frac * self.t_star_s
        return self.t_star_s


class Clairvoyant(Policy):
    """Offline optimal: sees the actual next gap (ski-rental lower bound).

    Per idle gap g the optimal action is: stay warm iff
    P_park * g  <  (P_load - P_base) * t_load, i.e. iff g < T*_exact.
    Evicting is instantaneous here, so this bounds ANY online policy.
    """

    clairvoyant = True

    def __init__(self, loader: LoaderSpec, profile: DeviceProfile):
        self.t_star_s = breakeven_seconds(loader, profile,
                                          paper_convention=False)
        self.name = "clairvoyant-optimal"

    def idle_timeout_s(self, now_s, next_gap_s=None) -> float:
        if next_gap_s is None:
            raise ValueError("Clairvoyant policy needs next_gap_s")
        return math.inf if next_gap_s < self.t_star_s else 0.0
