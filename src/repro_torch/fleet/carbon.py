"""Time-varying grid carbon intensity: traces, generators, zone presets.

The paper prices the parking tax at a FIXED grid intensity (kgCO2e =
kWh x scalar); real grids swing 3-10x over a day (solar duck curves,
night wind), so WHEN a joule is drawn changes its carbon cost even when
the joule count does not.  This module makes that first-class:

  * ``CarbonTrace`` -- a periodic piecewise-linear intensity curve
    i(t) in kgCO2e/kWh over a 24 h horizon, with exact integration
    (``integral``/``mean``/``carbon_kg``) so fleetsim can integrate
    emissions over the metered power timeline instead of multiplying
    total energy by a scalar.  A flat trace reproduces the scalar
    accounting bit-for-bit (the equivalence anchor fleetsim pins).
  * synthetic diurnal generators -- ``solar_duck`` (midday solar trough,
    evening ramp peak), ``wind_night`` (windy-night trough, midday
    peak), and ``flat_trace`` -- each scaled so the DAILY MEAN equals a
    target intensity, so swapping shapes never changes the zone's
    yearly-average bookkeeping.
  * per-zone presets -- ``trace_for_zone`` builds the preset shape named
    by ``catalog.ElectricityMix.trace_shape`` at that zone's mean
    intensity (ecologits per-zone-mix idiom, lifted to time-varying).

Every quantity is deterministic and exact for piecewise-linear traces:
segment integrals are trapezoids, no sampling error.  See
``docs/CARBON.md`` for the model and a worked example.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Iterable, List, Sequence, Tuple

DAY_S = 24 * 3600.0
_J_PER_KWH = 3.6e6


@dataclasses.dataclass(frozen=True)
class CarbonTrace:
    """Periodic piecewise-linear grid intensity i(t), kgCO2e/kWh.

    Args:
      name:     shape label (reported in FleetResult / bench rows).
      points:   ((t_s, kg_per_kwh), ...) knots with strictly increasing
                times in [0, period_s); intensity interpolates linearly
                between knots and wraps from the last knot back to the
                first (continuity across midnight).
      period_s: trace period; defaults to 24 h.

    A single-knot trace is constant (the scalar-accounting degenerate
    case); ``is_flat`` also detects multi-knot constant traces so the
    flat fast path stays exact whatever the construction.
    """
    name: str
    points: Tuple[Tuple[float, float], ...]
    period_s: float = DAY_S

    def __post_init__(self):
        pts = tuple((float(t), float(v)) for t, v in self.points)
        if not pts:
            raise ValueError("carbon trace needs at least one point")
        if self.period_s <= 0:
            raise ValueError("period must be positive")
        times = [t for t, _ in pts]
        if any(b <= a for a, b in zip(times, times[1:])):
            raise ValueError("trace times must be strictly increasing")
        if times[0] < 0 or times[-1] >= self.period_s:
            raise ValueError("trace times must lie in [0, period_s)")
        if any(v < 0 for _, v in pts):
            raise ValueError("carbon intensity cannot be negative")
        object.__setattr__(self, "points", pts)
        # knots extended to [0, period] (wrap value at both ends) +
        # prefix trapezoid integrals, so integral() is exact and O(log n)
        kt: List[float] = []
        kv: List[float] = []
        i0 = self._wrap_value_at_zero()
        if times[0] > 0.0:
            kt.append(0.0)
            kv.append(i0)
        for t, v in pts:
            kt.append(t)
            kv.append(v)
        kt.append(self.period_s)
        kv.append(i0)
        cum = [0.0]
        for i in range(1, len(kt)):
            cum.append(cum[-1]
                       + (kt[i] - kt[i - 1]) * (kv[i] + kv[i - 1]) / 2.0)
        object.__setattr__(self, "_kt", kt)
        object.__setattr__(self, "_kv", kv)
        object.__setattr__(self, "_cum", cum)

    def _wrap_value_at_zero(self) -> float:
        """Intensity at t=0 (and t=period) via the wrap segment from the
        last knot to the first knot of the next period."""
        (t0, v0), (tn, vn) = self.points[0], self.points[-1]
        if t0 == 0.0 or len(self.points) == 1:
            return v0
        span = (t0 + self.period_s) - tn        # > 0: times are strict
        return vn + (v0 - vn) * (self.period_s - tn) / span

    # -- point queries -------------------------------------------------------
    @property
    def is_flat(self) -> bool:
        """True when the intensity never varies: the scalar-accounting
        case, taken as an exact fast path everywhere."""
        v0 = self.points[0][1]
        return all(v == v0 for _, v in self.points)

    @property
    def daily_mean_kg_per_kwh(self) -> float:
        """Mean intensity over one full period (the zone's bookkeeping
        average; generators scale their shape so this hits the target)."""
        return self._cum[-1] / self.period_s

    def intensity_at(self, t_s: float) -> float:
        """i(t) in kgCO2e/kWh (periodic, linear between knots)."""
        if len(self.points) == 1:
            return self.points[0][1]
        p = t_s % self.period_s
        kt, kv = self._kt, self._kv
        j = bisect.bisect_right(kt, p) - 1
        j = min(max(j, 0), len(kt) - 2)
        span = kt[j + 1] - kt[j]
        if span <= 0:
            return kv[j]
        return kv[j] + (kv[j + 1] - kv[j]) * (p - kt[j]) / span

    # -- exact integration ---------------------------------------------------
    def _prefix(self, p: float) -> float:
        """F(p) = integral of i over [0, p] for p in [0, period]."""
        kt, kv, cum = self._kt, self._kv, self._cum
        j = bisect.bisect_right(kt, p) - 1
        j = min(max(j, 0), len(kt) - 2)
        dt = p - kt[j]
        if dt <= 0:
            return cum[j]
        return cum[j] + dt * (kv[j] + self.intensity_at(p)) / 2.0

    def integral(self, t0_s: float, t1_s: float) -> float:
        """Exact integral of i(t) dt over [t0, t1], in (kgCO2e/kWh)*s.

        Handles arbitrary horizons (whole periods factor out) and is the
        primitive every carbon quantity below reduces to."""
        if t1_s <= t0_s:
            return 0.0
        if len(self.points) == 1 or self.is_flat:
            return self.points[0][1] * (t1_s - t0_s)
        per, total = self.period_s, self._cum[-1]

        def g(t: float) -> float:
            k = math.floor(t / per)
            return k * total + self._prefix(t - k * per)

        return g(t1_s) - g(t0_s)

    def mean(self, t0_s: float, t1_s: float) -> float:
        """Mean intensity over [t0, t1] (i(t0) for an empty window)."""
        if t1_s <= t0_s:
            return self.intensity_at(t0_s)
        return self.integral(t0_s, t1_s) / (t1_s - t0_s)

    def carbon_kg(self, power_w: float, t0_s: float, t1_s: float) -> float:
        """kgCO2e of drawing a CONSTANT ``power_w`` over [t0, t1]:
        P * integral(i dt) / 3.6e6 (W*s per kWh)."""
        return power_w * self.integral(t0_s, t1_s) / _J_PER_KWH

    def carbon_for_segments(
            self, segments: Iterable[Tuple[float, float, float]]) -> float:
        """kgCO2e of a metered power timeline: ``segments`` is an
        iterable of (t0_s, t1_s, watts) with constant power per segment
        (exactly what ``EnergyMeter.timeline`` records).

        Flat traces take the energy-first path -- sum joules, multiply
        once -- so the result is bit-comparable with scalar accounting
        (``fsum`` keeps the sum exactly rounded either way)."""
        if self.is_flat:
            joules = math.fsum(p * (b - a) for a, b, p in segments)
            return joules * self.points[0][1] / _J_PER_KWH
        return math.fsum(self.carbon_kg(p, a, b) for a, b, p in segments)

    # -- transforms ----------------------------------------------------------
    def scaled_to_mean(self, target_kg_per_kwh: float) -> "CarbonTrace":
        """Rescale intensities so the daily mean equals ``target``
        (shape-preserving; how zone presets hit their mix average)."""
        mean = self.daily_mean_kg_per_kwh
        if mean <= 0.0:
            raise ValueError("cannot rescale an all-zero trace")
        k = target_kg_per_kwh / mean
        return CarbonTrace(self.name,
                           tuple((t, v * k) for t, v in self.points),
                           self.period_s)

    def shifted(self, dt_s: float) -> "CarbonTrace":
        """Phase-shift the curve: the returned trace reads
        ``self.intensity_at(t + dt_s)`` at time ``t`` -- how zone
        presets authored in LOCAL hours (solar trough ~13:00 local) are
        expressed on the fleet's shared sim clock.  A cyclic knot shift:
        same trapezoids in a different order, so the daily mean is
        preserved.  Identity (``self``) for flat traces or a whole-period
        shift, keeping single-zone runs bit-exact."""
        dt = dt_s % self.period_s
        if dt == 0.0 or self.is_flat:
            return self
        pts = []
        for t, v in self.points:
            nt = (t - dt) % self.period_s
            if nt >= self.period_s:         # fp guard on the mod wrap
                nt = 0.0
            pts.append((nt, v))
        pts.sort()
        return CarbonTrace(self.name, tuple(pts), self.period_s)


# ---------------------------------------------------------------------------
# Synthetic diurnal generators (all scaled to a target daily mean).
# ---------------------------------------------------------------------------

def flat_trace(mean_kg_per_kwh: float, name: str = "flat") -> CarbonTrace:
    """Constant intensity: exactly the paper's scalar accounting."""
    return CarbonTrace(name, ((0.0, float(mean_kg_per_kwh)),))


def _shaped(name: str, shape, mean_kg_per_kwh: float,
            knots: int = 48) -> CarbonTrace:
    """Sample ``shape(hour) -> relative intensity`` at ``knots`` evenly
    spaced knots and scale the piecewise-linear result to the mean."""
    pts = []
    for k in range(knots):
        h = 24.0 * k / knots
        pts.append((h * 3600.0, max(shape(h), 1e-6)))
    return CarbonTrace(name, tuple(pts)).scaled_to_mean(mean_kg_per_kwh)


def solar_duck(mean_kg_per_kwh: float, swing: float = 0.45) -> CarbonTrace:
    """Solar-heavy grid (CAISO-style duck curve): intensity dips through
    the midday solar belly (~13:00) and peaks on the evening ramp
    (~20:00) when solar rolls off into peaker plants.  ``swing`` sets
    the trough depth as a fraction of the base level."""
    if not 0.0 <= swing < 1.0:
        raise ValueError("swing must be in [0, 1)")

    def shape(h: float) -> float:
        belly = math.exp(-((h - 13.0) / 3.0) ** 2)
        ramp = math.exp(-((h - 20.0) / 2.0) ** 2)
        return 1.0 - swing * belly + 0.6 * swing * ramp

    return _shaped("solar-duck", shape, mean_kg_per_kwh)


def wind_night(mean_kg_per_kwh: float, swing: float = 0.35) -> CarbonTrace:
    """Wind-heavy grid: night wind floors the intensity around ~02:00
    and calm midday demand peaks it around ~14:00 (one smooth diurnal
    cosine -- the anti-phase of the solar belly)."""
    if not 0.0 <= swing < 1.0:
        raise ValueError("swing must be in [0, 1)")

    def shape(h: float) -> float:
        return 1.0 + swing * math.cos(2.0 * math.pi * (h - 14.0) / 24.0)

    return _shaped("wind-night", shape, mean_kg_per_kwh)


TRACE_SHAPES = {
    "flat": flat_trace,
    "solar-duck": solar_duck,
    "wind-night": wind_night,
}


def make_trace(shape: str, mean_kg_per_kwh: float) -> CarbonTrace:
    """Build a named shape at a target daily-mean intensity."""
    if shape not in TRACE_SHAPES:
        raise KeyError(
            f"unknown carbon trace shape {shape!r}; have "
            f"{sorted(TRACE_SHAPES)}")
    return TRACE_SHAPES[shape](mean_kg_per_kwh)


def trace_for_zone(zone: str) -> CarbonTrace:
    """The zone's preset diurnal shape at the zone's mean intensity,
    phase-shifted onto the sim clock by the zone's ``tz_offset_s``
    (``catalog.ElectricityMix`` names the shape and offset; the daily
    mean always equals ``gwp_kg_per_kwh``, so yearly totals agree with
    the scalar bookkeeping by construction)."""
    from repro_torch.fleet.catalog import get_mix
    mix = get_mix(zone)
    return make_trace(mix.trace_shape, mix.gwp_kg_per_kwh).shifted(
        mix.tz_offset_s)


def resolve_zone_trace(zone: str, carbon_trace=None,
                       scenario_zone: str = None) -> CarbonTrace:
    """THE zone->trace resolver: one owner of the zone->(trace, mean)
    mapping (prices stay on ``catalog.get_mix``), shared by the
    scenario-level resolution (``FleetScenario.resolved_carbon_trace``)
    and the per-device zone binding, so the two can never disagree.

    ``carbon_trace`` is the scenario-style spec:
      * ``None``        -> flat at the zone's mean (scalar accounting);
      * ``"zone"``      -> the zone's preset via ``trace_for_zone``;
      * a shape name    -> ``make_trace(shape, zone mean)``;
      * a CarbonTrace   -> as-is for the zone it was authored for (the
                          scenario zone), repriced to the target zone's
                          mean (shape-preserving ``scaled_to_mean``)
                          when a device sits in a DIFFERENT zone.
    """
    from repro_torch.fleet.catalog import get_mix
    mix = get_mix(zone)
    if carbon_trace is None:
        return flat_trace(mix.gwp_kg_per_kwh)
    if isinstance(carbon_trace, CarbonTrace):
        if scenario_zone is None or get_mix(scenario_zone).zone == mix.zone:
            return carbon_trace
        return carbon_trace.scaled_to_mean(mix.gwp_kg_per_kwh)
    if carbon_trace == "zone":
        return trace_for_zone(mix.zone)
    return make_trace(carbon_trace, mix.gwp_kg_per_kwh)


class CarbonBreakeven:
    """Carbon-aware ski-rental eviction: the paper's Eq.-12 breakeven
    T* = E_load / P_park, repriced in kgCO2e under a time-varying grid.

    The classic ski-rental argument evicts when cumulative parking cost
    reaches the reload cost.  With intensity i(t) the parking side is
    an integral and the reload is priced AT THE EVICTION INSTANT (the
    adversarial arrival lands right after you evict), so the policy
    evicts at the smallest tau with

        P_park * integral(i, now, now+tau)  >=  E_load * i(now+tau)
        <=>   integral(i, now, now+tau)     >=  T* * i(now+tau)

    (divide by P_park; T* = E_load / P_park is Eq. 12).  On a flat
    trace this is exactly tau = T* -- the energy ``Breakeven`` policy,
    so the fleet equivalence anchors are untouched.  On a diurnal
    trace the behaviour is reload-shifting: riding INTO a peak the
    right side grows and the policy holds the model warm through the
    expensive hours (a reload there would be carbon-dear); riding into
    a trough the reload gets cheap ahead and it evicts early, so the
    reload work lands in the low-intensity window.  tau is capped at
    4 T* (bounded exposure when intensity keeps rising).

    Instantiate via ``FleetModelSpec(policy_factory=CarbonBreakeven)``:
    the cluster feeds each replica its own loader/profile AND the run's
    resolved trace (``Cluster.carbon_trace``) through the factory
    signature, the same way ``Breakeven`` receives loader/profile.

    Args:
      loader / profile: the replica's cold-start + power constants.
      carbon_trace:     the run's intensity curve (None -> energy T*).
      paper_convention: Eq.-12 full-loading-power convention (default),
                        as the energy Breakeven policy uses.
    """

    name = "carbon-breakeven"
    clairvoyant = False
    _CAP_TSTARS = 4.0
    _GRID = 48                  # stopping-time scan resolution

    def __init__(self, loader, profile, *,
                 carbon_trace: "CarbonTrace" = None,
                 paper_convention: bool = True):
        from repro_torch.core.breakeven import breakeven_seconds
        self.t_star_s = breakeven_seconds(loader, profile,
                                          paper_convention=paper_convention)
        self.carbon_trace = carbon_trace
        self.name = f"carbon-breakeven(T*={self.t_star_s:.0f}s)"

    def reset(self) -> None:
        pass

    def observe_arrival(self, t_s: float) -> None:
        pass

    def idle_timeout_s(self, now_s: float, next_gap_s=None) -> float:
        """Idle tolerance from ``now_s`` (the stopping time above);
        exactly T* when no varying trace is bound."""
        t = self.carbon_trace
        ts = self.t_star_s
        if t is None or t.is_flat or not math.isfinite(ts) or ts <= 0:
            return ts
        cap = self._CAP_TSTARS * ts
        prev_tau = 0.0
        prev_g = -ts * t.intensity_at(now_s)
        for k in range(1, self._GRID + 1):
            tau = cap * k / self._GRID
            g = t.integral(now_s, now_s + tau) \
                - ts * t.intensity_at(now_s + tau)
            if g >= 0.0:
                if g > prev_g:          # linear refine inside the cell
                    frac = -prev_g / (g - prev_g)
                    return prev_tau + frac * (tau - prev_tau)
                return tau
            prev_tau, prev_g = tau, g
        return cap


def carbon_timeline_kg(trace: CarbonTrace,
                       segments: Sequence[Tuple[float, float, float]],
                       bin_s: float = 3600.0,
                       end_s: float = 0.0) -> List[Tuple[float, float]]:
    """Cumulative kgCO2e sampled at bin boundaries: [(t_s, kg_so_far)].

    ``segments`` is a metered power timeline ((t0, t1, watts)); bins
    default to hourly.  The last bin extends to cover the latest segment
    even when a final load burst overshoots ``end_s`` (exactly as the
    fleet energy accounting lets the final burst overshoot the horizon).
    """
    return carbon_timeline_multi_kg([(trace, s) for s in segments],
                                    bin_s=bin_s, end_s=end_s)


def carbon_timeline_multi_kg(
        traced_segments: Sequence[Tuple[CarbonTrace,
                                        Tuple[float, float, float]]],
        bin_s: float = 3600.0,
        end_s: float = 0.0) -> List[Tuple[float, float]]:
    """``carbon_timeline_kg`` with a per-segment trace: the multi-zone
    fleet form, where each device's power segments integrate against
    that device's zone trace.  Walks the segments in the given order
    with the single-trace arithmetic, so a fleet whose devices all share
    one trace object reproduces ``carbon_timeline_kg`` bit-for-bit."""
    if bin_s <= 0:
        raise ValueError("bin width must be positive")
    last = max((b for _, (_, b, _) in traced_segments), default=0.0)
    end = max(end_s, last)
    n = max(int(math.ceil(end / bin_s - 1e-12)), 1)
    bins = [0.0] * n
    for trace, (a, b, p) in traced_segments:
        if b <= a:
            continue
        j = min(int(a // bin_s), n - 1)
        t = a
        while t < b:
            hi = min(b, (j + 1) * bin_s) if j < n - 1 else b
            bins[j] += trace.carbon_kg(p, t, hi)
            t = hi
            j += 1
    out: List[Tuple[float, float]] = []
    cum = 0.0
    for j, kg in enumerate(bins):
        cum += kg
        out.append((min((j + 1) * bin_s, end), cum))
    return out
