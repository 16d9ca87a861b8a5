"""Device power-state machine: the single authority on what a device's
power states ARE, which transitions between them are legal, and what
each state costs.

Before this module the power semantics were smeared across four layers
(stringly-typed meter states, idle/active formulas in ``power_model``,
override composition in ``Cluster.sync_power``, ad-hoc handling in
``fleetsim``).  Every consumer now drives the same machine:

  * ``PowerState`` -- the typed states.  The str-enum VALUES are the
    historical wire names (``"parked"`` for ``CTX_IDLE``), so meter
    reports, bench rows, and pinned tests keep their keys.
  * ``LEGAL_TRANSITIONS`` -- the transition table.  Illegal transitions
    (serving on a sleeping device, waking straight into a load) RAISE
    ``IllegalPowerTransition`` instead of silently mispricing energy.
  * ``PowerStateMachine`` -- a tiny validated state holder (current
    state + when it was entered); ``EnergyMeter`` owns one per device
    and the reference simulator drives one for validation.
  * ``TransitionModel`` -- per-SKU wake latency / wake energy.
    Context-create is the paper's DVFS step (a standing power change,
    not a lump); sleep/wake are the new ``DeviceProfile`` fields
    (engineering estimates -- the paper never powers a device down).
  * ``state_power_w`` -- the per-state power formula (Eq. 1 extended
    below bare idle), shared by the meter and ``core/simulator.py``.
  * ``gate_breakeven_s`` -- the device-level ski rental: sleeping is
    worth it iff the expected bare-idle gap exceeds the wake-energy
    breakeven (the Eq.-12 argument of ``core/breakeven.py`` one level
    down the power ladder: reload->wake, DVFS step->bare-minus-sleep).

States, low to high power::

    OFF -- SLEEP -- BARE -- CTX_IDLE ("parked") -- LOADING -- ACTIVE

Overlap (a load streaming while other models decode) is NOT a seventh
state: it meters through the composed-override channel -- the meter
enters a base state with an explicit composed wattage
(``transition(state, power_override_w=...)``), which is how
``Cluster.sync_power`` prices concurrent phases additively.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, FrozenSet, Optional, Union

from repro_torch.core.power_model import DeviceProfile


class PowerState(str, enum.Enum):
    """Typed device power states.  Values are the historical meter/report
    names (``CTX_IDLE`` reports as ``"parked"``), so energy buckets and
    pinned bench keys are unchanged by the typed refactor."""

    OFF = "off"            # machine powered down (0 W; not used by the sim)
    SLEEP = "sleep"        # gated: below bare idle, must wake before use
    BARE = "bare"          # bare idle, no runtime context (P_base)
    CTX_IDLE = "parked"    # live context, 0% util -- pays the DVFS step
    LOADING = "loading"    # weight ingest burst (loader-specific watts)
    ACTIVE = "active"      # decode slots busy

    @classmethod
    def coerce(cls, state: Union["PowerState", str]) -> "PowerState":
        """Accept a ``PowerState`` or a legacy string state name."""
        if isinstance(state, cls):
            return state
        try:
            return cls(state)
        except ValueError:
            raise ValueError(
                f"unknown power state {state!r}; have "
                f"{sorted(s.value for s in cls)}") from None


#: Legal state changes (self-loops are always legal: re-entering the
#: current state is how the meter flushes an interval or swaps the
#: composed override).  SLEEP and OFF are deliberately strict: a gated
#: device can only come back through BARE -- it cannot grow a context,
#: start a load, or serve without an explicit wake, so a scheduler bug
#: that routes work to a sleeping device raises instead of metering
#: wrong watts.
LEGAL_TRANSITIONS: Dict[PowerState, FrozenSet[PowerState]] = {
    PowerState.OFF: frozenset({PowerState.BARE}),
    # SLEEP's only exit is the metered wake ramp into BARE -- even a
    # full power-off must wake first, so no sleep exit escapes metering
    PowerState.SLEEP: frozenset({PowerState.BARE}),
    PowerState.BARE: frozenset({
        PowerState.OFF, PowerState.SLEEP, PowerState.CTX_IDLE,
        PowerState.LOADING, PowerState.ACTIVE}),
    PowerState.CTX_IDLE: frozenset({
        PowerState.BARE, PowerState.LOADING, PowerState.ACTIVE}),
    # BARE from LOADING/ACTIVE: device failure drops mid-phase
    PowerState.LOADING: frozenset({
        PowerState.BARE, PowerState.CTX_IDLE, PowerState.ACTIVE}),
    PowerState.ACTIVE: frozenset({
        PowerState.BARE, PowerState.CTX_IDLE, PowerState.LOADING}),
}


class IllegalPowerTransition(ValueError):
    """A state change outside ``LEGAL_TRANSITIONS`` was requested."""


def can_transition(src: PowerState, dst: PowerState) -> bool:
    """Whether ``src -> dst`` is legal (self-loops always are)."""
    return dst is src or dst in LEGAL_TRANSITIONS[src]


class PowerStateMachine:
    """Validated holder of one device's power state.

    Tracks the CURRENT state and when it was entered (self-loops do not
    reset the entry time -- re-settling into bare keeps the bare-idle
    clock running, which is what the gating ski rental measures).
    """

    def __init__(self, initial: PowerState = PowerState.BARE,
                 now_s: float = 0.0):
        self.state = PowerState.coerce(initial)
        self.entered_at_s = now_s

    def to(self, dst: Union[PowerState, str], now_s: float) -> bool:
        """Move to ``dst`` at ``now_s``; returns whether the state
        actually CHANGED.  Raises ``IllegalPowerTransition`` on a move
        outside the table (state unchanged on raise)."""
        dst = PowerState.coerce(dst)
        if dst is self.state:
            return False
        if dst not in LEGAL_TRANSITIONS[self.state]:
            raise IllegalPowerTransition(
                f"illegal power transition {self.state.value!r} -> "
                f"{dst.value!r}")
        self.state = dst
        self.entered_at_s = now_s
        return True

    def time_in_state_s(self, now_s: float) -> float:
        return max(now_s - self.entered_at_s, 0.0)


def state_power_w(profile: DeviceProfile, state: Union[PowerState, str],
                  loader=None, *, service_util: float = 0.6) -> float:
    """Watts a device draws in ``state`` -- paper Eq. 1 extended below
    bare idle, the one formula the meter AND the reference simulator
    integrate.

    ``loader`` (a ``LoaderSpec``) prices LOADING per loading method;
    without one the profile's own per-SKU ``p_load_w`` is used (the
    field that replaced the old ``p_base_w + 30.0`` magic)."""
    state = PowerState.coerce(state)
    if state is PowerState.OFF:
        return 0.0
    if state is PowerState.SLEEP:
        return profile.p_sleep_w
    if state is PowerState.BARE:
        return profile.p_base_w
    if state is PowerState.CTX_IDLE:
        return profile.idle_power_w(context_active=True)
    if state is PowerState.LOADING:
        return profile.load_power_w(loader)
    return profile.active_power_w(service_util)


@dataclasses.dataclass(frozen=True)
class TransitionModel:
    """Per-SKU cost of the gated transitions.

    ``wake_s`` / ``wake_energy_j``: the SLEEP -> BARE ramp (GPU
    software re-init + clock bring-up); the wake window draws
    ``wake_energy_j / wake_s`` watts for ``wake_s`` seconds.
    ``p_sleep_w``: the gated floor while asleep.
    Context-create (BARE -> CTX_IDLE) is NOT a lump here: it is the
    paper's standing DVFS step, already carried by ``p_ctx_w``.
    """

    p_sleep_w: float
    wake_s: float
    wake_energy_j: float

    @classmethod
    def for_profile(cls, profile: DeviceProfile) -> "TransitionModel":
        return cls(p_sleep_w=profile.p_sleep_w,
                   wake_s=profile.wake_latency_s,
                   wake_energy_j=profile.wake_energy_j)

    @property
    def wake_power_w(self) -> float:
        """Mean power of the wake ramp (what the meter integrates)."""
        if self.wake_s <= 0.0:
            return 0.0
        return self.wake_energy_j / self.wake_s

    def wake_extra_j(self, p_base_w: float) -> float:
        """Extra joules one wake cycle costs over a device that had
        stayed bare through the same window."""
        return max(self.wake_energy_j - p_base_w * self.wake_s, 0.0)


def gate_breakeven_s(profile: DeviceProfile) -> float:
    """Device-level ski rental T*_gate: the bare-idle gap beyond which
    sleeping beats staying bare.

        stay bare over gap g:  P_base * g
        sleep + wake on demand: P_sleep * g + (E_wake - P_base * t_wake)

        T*_gate = (E_wake - P_base * t_wake) / (P_base - P_sleep)

    -- exactly Eq. 12 one power level down: the reload becomes the wake
    ramp, the DVFS step becomes the bare-minus-sleep delta.  Infinite
    when sleeping saves nothing (P_sleep >= P_base)."""
    tm = TransitionModel.for_profile(profile)
    save_w = profile.p_base_w - tm.p_sleep_w
    if save_w <= 0.0:
        return math.inf
    return tm.wake_extra_j(profile.p_base_w) / save_w


def wake_penalty_j(profile: DeviceProfile, hold_s: float = 0.0) -> float:
    """Marginal joules of waking a GATED device for a cold placement,
    versus leaving it asleep: the wake ramp's above-sleep energy plus
    the bare-minus-sleep delta held for ``hold_s`` (how long the device
    is expected to stay awake).  Routers and the autoscaler add this to
    a sleeping candidate's cold-placement score -- a gated device is
    cheap watts but slow (and not free) first-token."""
    tm = TransitionModel.for_profile(profile)
    ramp = max(tm.wake_energy_j - tm.p_sleep_w * tm.wake_s, 0.0)
    return ramp + (profile.p_base_w - tm.p_sleep_w) * max(hold_s, 0.0)
