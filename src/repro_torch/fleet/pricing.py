"""Dollar accounting and spot preemption: the price of standing warmth.

The paper's breakeven model (Eq. 12-13) prices parking in joules, but
the decision operators actually buy is dollars.  This module converts a
run's metered power-state timeline into money under the catalog's
purchase tiers, and models the failure mode that makes the cheap tier
cheap: spot revocation.

Billing semantics (the tier model docs/COST.md walks through):

  * ``on_demand`` and ``spot`` bill only POWERED-ON seconds -- every
    metered state except SLEEP and OFF.  Gating a device to sleep (or a
    preemption forcing it OFF) releases the rental; that is the dollar
    face of the parking tax, and it is what makes power gating show up
    on the cost axis at all.
  * ``reserved`` bills the whole horizon regardless of power state: the
    commitment is paid for whether the device sleeps or not, in exchange
    for a lower rate.

  * energy dollars reuse the per-zone tariff pricing
    (``catalog.energy_cost_usd``) that ``FleetResult.energy_usd``
    already carries -- ``cost_usd = gpu_hours_usd + energy_usd``.

Every reduction is ``math.fsum`` (correctly rounded regardless of
summand order), so the per-device / per-zone decompositions sum back to
the totals and agree across the event-loop and vectorized engines to
the same <=1e-9 rel the energy anchors hold.

Preemption (``PreemptionModel``) draws seeded spot revocations as pure
data; the engines replay them as events.  Only ``spot``-tier devices
are revocable.  The draw is per-device seeded (seed mixed with a CRC of
the instance id), so adding a device to the fleet never reshuffles
another device's fault times.
"""
from __future__ import annotations

import dataclasses
import math
import random
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.fleet.catalog import (DeviceInstance, energy_cost_usd, get_mix,
                                 normalize_tier)

# Power states whose seconds are NOT billed under usage tiers
# (on_demand / spot): the device is released back to the provider.
UNBILLED_STATES = ("sleep", "off")


def billed_seconds(durations_s: Dict[str, float], tier: str) -> float:
    """Rentable seconds in a per-state duration dict under ``tier``.

    ``reserved`` pays for every metered second (the commitment runs
    through sleep); usage tiers pay only for powered-on states.  fsum
    over sorted keys, so the result is correctly rounded and identical
    across engines whatever order their state dicts iterate in.
    """
    t = normalize_tier(tier)
    keys = sorted(k for k in durations_s if k != "total")
    if t == "reserved":
        return math.fsum(durations_s[k] for k in keys)
    return math.fsum(durations_s[k] for k in keys
                     if k not in UNBILLED_STATES)


def device_gpu_usd(device: DeviceInstance, durations_s: Dict[str, float],
                   tier: str) -> float:
    """Rental dollars for one device: its tier rate x billed hours."""
    t = normalize_tier(tier)
    return device.sku.price_usd_per_hr(t) * billed_seconds(durations_s,
                                                           t) / 3600.0


def device_tier_map(devices: Sequence[DeviceInstance],
                    default_tier: str = "on_demand") -> Dict[str, str]:
    """instance_id -> purchase tier: the device's own pinned tier
    (``DeviceInstance.tier``) or the scenario default, canonical --
    the exact inheritance shape of ``FleetScenario.device_zones``."""
    dt = normalize_tier(default_tier)
    return {d.instance_id: (normalize_tier(d.tier) if d.tier else dt)
            for d in devices}


def tier_billed_seconds(devices: Sequence[DeviceInstance],
                        reports: Sequence,
                        default_tier: str = "on_demand"
                        ) -> Dict[str, float]:
    """tier -> fsum of billed seconds across the devices billed under
    it: the scalar the fused metering kernel also emits per tier, and
    the cross-engine comparable for powered-on billing time.  Same
    report duck-typing as ``price_fleet``."""
    tiers = device_tier_map(devices, default_tier)
    out: Dict[str, float] = {}
    for t in sorted(set(tiers.values())):
        out[t] = math.fsum(
            billed_seconds(r.durations_s, t)
            for r in sorted(reports, key=lambda r: r.instance_id)
            if tiers[r.instance_id] == t)
    return out


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """One run's dollars, decomposed three ways.

    ``cost_usd = gpu_hours_usd + energy_usd`` exactly (one addition);
    ``device_cost_usd`` fsums to ``cost_usd`` and ``zone_cost_usd``
    fsums over ``device_cost_usd`` (both to float rounding, property-
    tested at 1e-12 rel like the zone decompositions).
    """
    cost_usd: float                       # total: rental + electricity
    gpu_hours_usd: float                  # rental: tier rate x billed hrs
    energy_usd: float                     # electricity at per-zone tariffs
    device_gpu_usd: Dict[str, float]      # instance_id -> rental dollars
    device_cost_usd: Dict[str, float]     # instance_id -> rental + energy
    zone_cost_usd: Dict[str, float]       # zone -> fsum of its devices
    device_tiers: Dict[str, str]          # instance_id -> tier billed under


def price_fleet(devices: Sequence[DeviceInstance], reports: Sequence,
                *, default_tier: str = "on_demand",
                energy_usd: float = 0.0) -> CostBreakdown:
    """Price a finished run from its device reports.

    ``reports`` duck-types ``fleetsim.DeviceReport``: each needs
    ``instance_id``, ``durations_s`` (per-state seconds), ``zone`` and
    ``energy_wh["total"]``.  ``energy_usd`` is the engine's own
    electricity total (the existing ``FleetResult.energy_usd``), passed
    through so ``cost_usd`` decomposes against the exact number the
    engines already anchor bit-exactly; the per-device energy dollars
    here re-price each device at its zone tariff and fsum back to it
    within float rounding.
    """
    by_id = {d.instance_id: d for d in devices}
    tiers = device_tier_map(devices, default_tier)
    gpu: Dict[str, float] = {}
    dev_cost: Dict[str, float] = {}
    dev_zone: Dict[str, str] = {}
    for r in reports:
        did = r.instance_id
        gpu[did] = device_gpu_usd(by_id[did], r.durations_s, tiers[did])
        dev_cost[did] = gpu[did] + energy_cost_usd(r.energy_wh["total"],
                                                   get_mix(r.zone))
        dev_zone[did] = get_mix(r.zone).zone
    zones = sorted(set(dev_zone.values()))
    zone_cost = {z: math.fsum(dev_cost[did] for did in sorted(dev_cost)
                              if dev_zone[did] == z) for z in zones}
    gpu_total = math.fsum(gpu[did] for did in sorted(gpu))
    return CostBreakdown(
        cost_usd=gpu_total + energy_usd,
        gpu_hours_usd=gpu_total,
        energy_usd=energy_usd,
        device_gpu_usd=gpu,
        device_cost_usd=dev_cost,
        zone_cost_usd=zone_cost,
        device_tiers=tiers)


# ---------------------------------------------------------------------------
# Spot preemption: seeded revocation draws (pure data; engines replay).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Revocation:
    """One spot revocation: the provider reclaims ``device_id``.

    The warning lands at ``warn_at_s`` (capacity planners stop placing
    on the device), power is cut at ``off_at_s`` (in-flight work is
    orphaned and re-queued), and the device -- if the outage is finite
    -- returns to BARE at ``restore_at_s``.
    """
    device_id: str
    off_at_s: float
    warning_s: float = 120.0
    outage_s: float = math.inf

    def __post_init__(self):
        if self.off_at_s < 0.0 or self.warning_s < 0.0:
            raise ValueError("revocation times must be non-negative")
        if self.outage_s <= 0.0:
            raise ValueError("outage must be positive")

    @property
    def warn_at_s(self) -> float:
        return max(self.off_at_s - self.warning_s, 0.0)

    @property
    def restore_at_s(self) -> float:
        return self.off_at_s + self.outage_s


@dataclasses.dataclass(frozen=True)
class PreemptionModel:
    """Seeded spot-revocation process.

    ``draw`` is PURE: same (model, fleet, horizon) -> same event list,
    so the event-loop and any replay engine inject identical faults.
    Each spot device runs an independent exponential clock at
    ``rate_per_device_day`` revocations per device-day, seeded from
    ``seed`` mixed with a CRC of its instance id -- growing the fleet
    never reshuffles an existing device's fault times.  The next draw
    starts after the previous outage ends (a device cannot be revoked
    while it is already gone).  ``schedule`` short-circuits the process
    with hand-pinned revocations (fault-injection tests).
    """
    rate_per_device_day: float = 0.0
    warning_s: float = 120.0
    outage_s: float = math.inf
    seed: int = 0
    schedule: Optional[Tuple[Revocation, ...]] = None

    def __post_init__(self):
        if self.rate_per_device_day < 0.0:
            raise ValueError("preemption rate must be non-negative")
        if self.warning_s < 0.0:
            raise ValueError("warning window must be non-negative")
        if self.outage_s <= 0.0:
            raise ValueError("outage must be positive")

    def draw(self, devices: Sequence[DeviceInstance],
             tiers: Dict[str, str], horizon_s: float) -> List[Revocation]:
        """The run's revocations, sorted by (off time, device id).

        Only ``spot``-tier devices (per ``tiers``, the resolved
        instance_id -> tier map) are revocable; revocations whose OFF
        lands at/after the horizon are dropped.
        """
        if self.schedule is not None:
            evs = [r for r in self.schedule if r.off_at_s < horizon_s]
            return sorted(evs, key=lambda r: (r.off_at_s, r.device_id))
        if self.rate_per_device_day <= 0.0:
            return []
        rate_per_s = self.rate_per_device_day / 86400.0
        out: List[Revocation] = []
        for d in devices:
            did = d.instance_id
            if tiers.get(did) != "spot":
                continue
            rng = random.Random((self.seed << 32)
                                ^ zlib.crc32(did.encode("utf-8")))
            t = rng.expovariate(rate_per_s)
            while t < horizon_s:
                out.append(Revocation(did, off_at_s=t,
                                      warning_s=self.warning_s,
                                      outage_s=self.outage_s))
                restore = t + self.outage_s
                if not math.isfinite(restore) or restore >= horizon_s:
                    break
                t = restore + rng.expovariate(rate_per_s)
        return sorted(out, key=lambda r: (r.off_at_s, r.device_id))
