"""Energy accounting for the serving runtime (the paper's Eq. 1 applied
to a live system).

``EnergyMeter`` integrates device power over power-state intervals.  The
states are the typed ``core.power_states.PowerState`` machine -- sleep
(gated) / bare (no context) / parked (context idle, pays the context
tax) / loading / active -- and every transition is validated against the
machine's legality table, so a scheduler bug that e.g. serves on a
sleeping device raises ``IllegalPowerTransition`` instead of silently
metering the wrong watts.  The paper's central result means the meter
does NOT need to know HOW MUCH memory a parked model uses -- only
whether a runtime context is live (beta ~ 0, section 4.2).

Per-state power comes from ``power_states.state_power_w`` (one formula
shared with ``core/simulator.py``); concurrent phases meter through the
composed-override channel (``transition(state, power_override_w=...)``).

A ``SimClock`` lets the 24 h example and the tests run in simulated time;
production would pass time.monotonic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.power_model import DeviceProfile
from repro_torch.core.power_states import (IllegalPowerTransition, PowerState,
                                     PowerStateMachine, TransitionModel,
                                     state_power_w)


class SimClock:
    def __init__(self, t0: float = 0.0):
        self._t = t0

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time cannot go backwards")
        self._t += dt


@dataclasses.dataclass
class EnergyMeter:
    profile: DeviceProfile
    clock: Callable[[], float]

    def __post_init__(self):
        self._machine = PowerStateMachine(PowerState.BARE, self.clock())
        self._since = self.clock()
        self._energy_j: Dict[str, float] = {}
        self._durations_s: Dict[str, float] = {}
        self._power_override: Optional[float] = None
        # sleep/wake bookkeeping (power_states.TransitionModel): wake
        # ramps meter as BARE with the ramp's mean power composed over
        # the override channel, so `wakes` is what turns the metered
        # "bare" bucket back into a gating saving (gated_wh_saved)
        self.wakes = 0
        # metered power timeline: (t0_s, t1_s, watts) per closed interval
        # (constant power within each).  This is what lets carbon be an
        # INTEGRAL over a time-varying grid-intensity trace instead of
        # energy x scalar (fleet/carbon.py) -- same instants, same watts
        # as the energy sums above, so flat-trace carbon is exactly the
        # scalar bookkeeping.
        self.timeline: List[Tuple[float, float, float]] = []

    def _power_w(self, state: PowerState) -> float:
        # an explicit override wins in ANY state: concurrent phases
        # (load overlapping decode, the wake ramp) meter at their
        # composed power
        if self._power_override is not None:
            return self._power_override
        return state_power_w(self.profile, state)

    def transition(self, state: Union[PowerState, str], *,
                   power_override_w: Optional[float] = None) -> None:
        """Close the current interval and enter `state` (validated:
        raises ``IllegalPowerTransition`` on a move outside the state
        machine's table, without mutating the meter)."""
        state = PowerState.coerce(state)
        now = self.clock()
        cur = self._machine.state
        self._machine.to(state, now)         # raises BEFORE any charge
        dt = now - self._since
        p = self._power_w(cur)
        key = cur.value
        self._energy_j[key] = self._energy_j.get(key, 0.0) + dt * p
        self._durations_s[key] = self._durations_s.get(key, 0.0) + dt
        if dt > 0.0:
            # coalesce contiguous equal-power intervals (sync_power often
            # re-settles into the same state): lossless for integration
            # and bounds growth to one entry per actual power CHANGE.
            # NOTE: in a long-lived production meter (time.monotonic
            # clock) this list still grows with every power change --
            # flush it after pricing (timeline.clear()) in that setting.
            if self.timeline and self.timeline[-1][1] == self._since \
                    and self.timeline[-1][2] == p:
                self.timeline[-1] = (self.timeline[-1][0], now, p)
            else:
                self.timeline.append((self._since, now, p))
        self._since = now
        self._power_override = power_override_w

    @property
    def state(self) -> PowerState:
        """Current power state (str-enum: compares equal to the legacy
        string names, e.g. ``meter.state == "parked"``)."""
        return self._machine.state

    @property
    def power_override_w(self) -> Optional[float]:
        """The composed-override wattage currently in force (None when
        the state's own formula prices the interval)."""
        return self._power_override

    def state_since_s(self) -> float:
        """Sim time the CURRENT state was entered (self-loop flushes do
        not reset it -- this is the bare-idle clock the gating ski
        rental measures)."""
        return self._machine.entered_at_s

    # -- sleep/wake gating ---------------------------------------------------
    def gate(self) -> None:
        """BARE -> SLEEP (raises from any other state, and from
        bare-with-a-composed-burst -- e.g. mid-wake: only a fully
        drained, SETTLED device may gate)."""
        if self._power_override is not None:
            raise IllegalPowerTransition(
                "cannot gate: a composed power burst is in force")
        self.transition(PowerState.SLEEP)

    def begin_wake(self) -> float:
        """Start the SLEEP -> BARE wake ramp; returns its duration.

        The ramp meters as BARE with the ramp's mean power
        (``wake_energy_j / wake_latency_s``) composed over the override
        channel, so the metered joules over the window are exactly the
        profile's ``wake_energy_j``."""
        tm = TransitionModel.for_profile(self.profile)
        self.transition(PowerState.BARE, power_override_w=tm.wake_power_w)
        self.wakes += 1
        return tm.wake_s

    def finish_wake(self) -> None:
        """Close the wake ramp: settle at plain bare power."""
        self.transition(PowerState.BARE)

    def gated_wh_saved(self) -> float:
        """Wh saved by gating vs having idled bare through the same
        windows: (P_base - P_sleep) over the slept time, minus each wake
        ramp's extra energy over bare.  Uses flushed durations -- call
        after ``totals()``/``peek_totals()`` semantics apply."""
        prof = self.profile
        tm = TransitionModel.for_profile(prof)
        sleep_s = self._durations_s.get(PowerState.SLEEP.value, 0.0)
        saved_j = (prof.p_base_w - tm.p_sleep_w) * sleep_s \
            - self.wakes * tm.wake_extra_j(prof.p_base_w)
        return saved_j / 3600.0

    # -- reporting -----------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        """Finalize up to 'now' and report energy (Wh) per state + total.

        MUTATES the meter: the open interval is flushed (closed at the
        current clock and appended to ``timeline``); the state and any
        composed override are preserved, so calling ``totals()`` twice
        (or mid-run) is safe and the second call only adds the newly
        elapsed interval.  For a pure read use ``peek_totals()``."""
        self.transition(self._machine.state,
                        power_override_w=self._power_override)
        wh = {k: v / 3600.0 for k, v in self._energy_j.items()}
        wh["total"] = sum(wh.values())
        return wh

    def peek_totals(self) -> Dict[str, float]:
        """Energy (Wh) per state + total as of 'now', WITHOUT mutating
        the meter (the open interval is priced virtually; no flush, no
        timeline append)."""
        dt = self.clock() - self._since
        cur = self._machine.state
        wh = {k: v / 3600.0 for k, v in self._energy_j.items()}
        wh[cur.value] = wh.get(cur.value, 0.0) + dt * self._power_w(cur) / 3600.0
        wh["total"] = sum(v for k, v in wh.items())
        return wh

    def durations(self) -> Dict[str, float]:
        return dict(self._durations_s)

    def parking_tax_wh(self) -> float:
        """Energy attributable to the context DVFS step while parked."""
        parked_s = self._durations_s.get(PowerState.CTX_IDLE.value, 0.0)
        return parked_s * self.profile.dvfs_step_w / 3600.0
