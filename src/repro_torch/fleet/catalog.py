"""GPU fleet catalog: SKUs, capacity, prices, and electricity mixes.

The fleet layer needs three things the per-device ``DeviceProfile`` does
not carry: (1) capacity -- how many models a device can host (VRAM +
runtime slots), (2) what an hour of the device costs, and (3) what a
kWh drawn in some region costs in dollars and in carbon.  The shapes
follow the two related repos: a cloud GPU catalog keyed by SKU with
per-tier prices (dgx-cloud demo) and a per-zone electricity-mix
repository (ecologits).

Prices are representative public cloud list prices (USD per device-hour,
mid-2026), NOT paper measurements: the bench reports relative numbers
and clearly labels absolute dollars as catalog estimates.  Carbon
intensities are grid yearly averages (kgCO2e/kWh); the USA value matches
``repro_torch.core.impact.US_GRID_KG_CO2_PER_KWH``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core import power_states
from repro_torch.core.impact import US_GRID_KG_CO2_PER_KWH
from repro_torch.core.power_model import DeviceProfile, get_profile


# ---------------------------------------------------------------------------
# Electricity mixes (ecologits idiom: one record per zone).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElectricityMix:
    """Grid characteristics of one operating zone.

    gwp_kg_per_kwh: Global Warming Potential of the mix (kgCO2eq/kWh)
                    -- the DAILY MEAN; the time-varying intensity curve
                    is ``trace_shape`` scaled to this mean
                    (fleet/carbon.py ``trace_for_zone``).
    usd_per_kwh:    industrial electricity price.
    trace_shape:    preset diurnal shape name in ``carbon.TRACE_SHAPES``
                    ("flat" / "solar-duck" / "wind-night").
    tz_offset_s:    local-clock offset vs the fleet's shared sim clock
                    (which is US-fleet local time, the paper's telemetry
                    frame).  Shapes are authored in LOCAL hours (solar
                    trough ~13:00 local); ``trace_for_zone`` phase-shifts
                    them onto the sim clock, so zones peak and trough at
                    different sim times -- the spread follow-the-sun
                    placement exploits.
    region:         coarse geographic region ("NA"/"EU"/"AS"/"GLOBAL"),
                    used by ``zone_hops`` to price cross-zone transfers.
    """
    zone: str
    gwp_kg_per_kwh: float
    usd_per_kwh: float
    trace_shape: str = "flat"
    tz_offset_s: float = 0.0
    region: str = "GLOBAL"


# The USA intensity is DERIVED from core.impact (single source of truth
# for the paper's 180 kT figure); core cannot import fleet, so the
# dependency points this way.
MIXES: Dict[str, ElectricityMix] = {
    "WOR": ElectricityMix("WOR", 0.481, 0.14),   # world average
    "USA": ElectricityMix("USA", US_GRID_KG_CO2_PER_KWH, 0.12,
                          trace_shape="solar-duck", region="NA"),
    "DEU": ElectricityMix("DEU", 0.350, 0.26, trace_shape="solar-duck",
                          tz_offset_s=7 * 3600.0, region="EU"),
    "FRA": ElectricityMix("FRA", 0.056, 0.18,    # nuclear: near-flat
                          tz_offset_s=7 * 3600.0, region="EU"),
    "SWE": ElectricityMix("SWE", 0.020, 0.10, trace_shape="wind-night",
                          tz_offset_s=7 * 3600.0, region="EU"),
    "IND": ElectricityMix("IND", 0.708, 0.08, trace_shape="solar-duck",
                          tz_offset_s=11.5 * 3600.0, region="AS"),
}


def get_mix(zone: str) -> ElectricityMix:
    """Look up a zone's electricity mix (case-insensitive; KeyError
    lists the known zones)."""
    key = zone.upper()
    if key not in MIXES:
        raise KeyError(f"unknown electricity mix {zone!r}; have {sorted(MIXES)}")
    return MIXES[key]


def energy_cost_usd(energy_wh: float, mix: ElectricityMix) -> float:
    """Dollar cost of ``energy_wh`` at the zone's industrial price."""
    return energy_wh / 1e3 * mix.usd_per_kwh


def carbon_kg(energy_wh: float, mix: ElectricityMix) -> float:
    """SCALAR kgCO2e of ``energy_wh`` at the zone's mean intensity --
    the fixed-intensity bookkeeping the paper uses.  Time-varying
    pricing lives in fleet/carbon.py (equal to this under a flat
    trace, pinned to 1e-9 kg)."""
    return energy_wh / 1e3 * mix.gwp_kg_per_kwh


# ---------------------------------------------------------------------------
# SKUs (cloud-catalog idiom: capacity + per-tier device-hour prices).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GPUSku:
    """One rentable accelerator model: power physics + capacity + price."""
    key: str
    profile: DeviceProfile
    slots: int                       # max co-resident model contexts
    usd_per_hr: float                # on-demand device-hour price
    usd_per_hr_reserved: float
    usd_per_hr_spot: float
    # peak dense bf16 throughput (vendor datasheet, no sparsity): the
    # compute roof the service-time model (serving/service_model.py)
    # divides through its MFU; memory bandwidth rides on the profile.
    tflops_bf16: float = 0.0

    @property
    def vram_gb(self) -> float:
        return self.profile.vram_capacity_gb

    def price_usd_per_hr(self, tier: str = "on_demand") -> float:
        try:
            return {"on_demand": self.usd_per_hr,
                    "reserved": self.usd_per_hr_reserved,
                    "spot": self.usd_per_hr_spot}[tier]
        except KeyError:
            raise KeyError(f"unknown price tier {tier!r}") from None


# Purchase tiers a device can be rented under.  Billing semantics live
# in fleet/pricing.py: on_demand and spot bill only powered-on hours
# (SLEEP/OFF release the device), reserved bills the whole horizon;
# spot is the only tier subject to preemption.
PRICE_TIERS = ("on_demand", "reserved", "spot")


def normalize_tier(tier: str) -> str:
    """Canonicalize a price-tier name (case/dash-insensitive; KeyError
    lists the tiers)."""
    t = tier.lower().replace("-", "_")
    if t not in PRICE_TIERS:
        raise KeyError(f"unknown price tier {tier!r}; have "
                       f"{sorted(PRICE_TIERS)}")
    return t


CATALOG: Dict[str, GPUSku] = {
    "h100": GPUSku("h100", get_profile("h100"), slots=8,
                   usd_per_hr=6.98, usd_per_hr_reserved=4.80,
                   usd_per_hr_spot=2.90, tflops_bf16=989.0),
    "a100": GPUSku("a100", get_profile("a100"), slots=8,
                   usd_per_hr=4.10, usd_per_hr_reserved=3.20,
                   usd_per_hr_spot=1.70, tflops_bf16=312.0),
    "l40s": GPUSku("l40s", get_profile("l40s"), slots=6,
                   usd_per_hr=1.90, usd_per_hr_reserved=1.40,
                   usd_per_hr_spot=0.80, tflops_bf16=362.0),
    "tpu_v5e": GPUSku("tpu_v5e", get_profile("tpu_v5e"), slots=2,
                      usd_per_hr=1.20, usd_per_hr_reserved=0.94,
                      usd_per_hr_spot=0.50, tflops_bf16=197.0),
}


def get_sku(key: str) -> GPUSku:
    """Look up a SKU by key (case/dash-insensitive; KeyError lists the
    catalog)."""
    k = key.lower().replace("-", "_")
    if k not in CATALOG:
        raise KeyError(f"unknown SKU {key!r}; have {sorted(CATALOG)}")
    return CATALOG[k]


# ---------------------------------------------------------------------------
# Fleet construction.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceInstance:
    """One physical device in the fleet (SKU + stable identity).

    ``zone`` is the device's electricity zone (a ``MIXES`` key), or
    ``None`` to inherit the scenario zone -- so single-zone fleets carry
    no per-device zone state and every existing spec parses unchanged.
    ``tier`` is the device's purchase tier (a ``PRICE_TIERS`` entry), or
    ``None`` to inherit the scenario ``price_tier`` -- same inheritance
    shape as zones, so tier-less specs parse unchanged too.
    """
    instance_id: str
    sku: GPUSku
    zone: Optional[str] = None
    tier: Optional[str] = None

    @property
    def profile(self) -> DeviceProfile:
        return self.sku.profile


_SPEC_PART = re.compile(
    r"^\s*(?:(\d+)\s*[xX]\s*)?([a-zA-Z0-9_\-]+?)\s*(?:@\s*([a-zA-Z]+)\s*)?"
    r"(?::\s*([a-zA-Z_\-]+)\s*)?$")


def _split_token(key: str) -> tuple:
    """Split an ``sku[@ZONE][:tier]`` token into (sku_key, zone, tier)."""
    tier = None
    if ":" in key:
        key, _, t = key.partition(":")
        tier = normalize_tier(t.strip())
    if "@" in key:
        sku_key, _, zone = key.partition("@")
        return sku_key.strip(), get_mix(zone.strip()).zone, tier
    return key.strip(), None, tier


def build_fleet(spec: Union[str, Sequence[str]]) -> List[DeviceInstance]:
    """Build device instances from a spec like ``"2xh100+2xa100+2xl40s"``.

    Each part takes an optional ``@ZONE`` suffix pinning those devices
    to an electricity zone (``"2xh100@DEU+2xa100@USA+2xl40s@IND"``) and
    an optional ``:tier`` suffix pinning their purchase tier
    (``"2xh100@DEU:spot"``); zone-less / tier-less parts inherit the
    scenario zone / price tier at run time.  Also accepts a sequence of
    SKU keys (``"sku[@ZONE][:tier]"``, one instance each).  Instance ids
    are ``<sku>-<i>`` and are stable across runs (deterministic routing
    tie-breaks sort on them).
    """
    if isinstance(spec, str):
        parts = [p for p in spec.split("+") if p.strip()]
        if not parts:
            raise ValueError(f"empty fleet spec {spec!r}")
        expanded: List[str] = []
        for part in parts:
            m = _SPEC_PART.match(part)
            if not m:
                raise ValueError(f"bad fleet spec part {part!r}")
            count = int(m.group(1) or 1)
            token = (m.group(2)
                     + (f"@{m.group(3)}" if m.group(3) else "")
                     + (f":{m.group(4)}" if m.group(4) else ""))
            expanded.extend([token] * count)
    else:
        expanded = list(spec)
    counters: Dict[str, int] = {}
    out: List[DeviceInstance] = []
    for key in expanded:
        sku_key, zone, tier = _split_token(key)
        sku = get_sku(sku_key)
        i = counters.get(sku.key, 0)
        counters[sku.key] = i + 1
        out.append(DeviceInstance(instance_id=f"{sku.key}-{i}", sku=sku,
                                  zone=zone, tier=tier))
    return out


def fleet_price_usd(devices: Sequence[DeviceInstance], horizon_s: float,
                    tier: str = "on_demand") -> float:
    """Infrastructure (rental) cost of holding the fleet for the horizon."""
    hours = horizon_s / 3600.0
    return sum(d.sku.price_usd_per_hr(tier) for d in devices) * hours


# ---------------------------------------------------------------------------
# Cross-zone transfer costs (follow-the-sun placement / migration).
# ---------------------------------------------------------------------------

# Moving a checkpoint between zones is not free: the WAN transfer burns
# network+storage energy and adds wall-clock before the load can start.
# Both are priced per GB per "hop" -- 0 hops within a zone, 1 between
# zones of the same region, 2 cross-region (the WOR pseudo-zone counts
# as its own region, so it is always 2 hops from a real zone).
XFER_J_PER_GB_HOP = 5400.0      # ~1.5 Wh/GB/hop (WAN transport estimate)
XFER_S_PER_GB_HOP = 0.8         # ~1.25 GB/s per hop (~10 Gbit effective)


def zone_hops(zone_a: str, zone_b: str) -> int:
    """Transfer distance between two zones in pricing hops."""
    a, b = get_mix(zone_a), get_mix(zone_b)
    if a.zone == b.zone:
        return 0
    if a.region == b.region and a.region != "GLOBAL":
        return 1
    return 2


def transfer_cost_j(checkpoint_gb: float, zone_a: str, zone_b: str) -> float:
    """Network energy of moving ``checkpoint_gb`` between zones (J)."""
    return XFER_J_PER_GB_HOP * checkpoint_gb * zone_hops(zone_a, zone_b)


def transfer_latency_s(checkpoint_gb: float, zone_a: str,
                       zone_b: str) -> float:
    """Added wall-clock of the cross-zone checkpoint transfer (s)."""
    return XFER_S_PER_GB_HOP * checkpoint_gb * zone_hops(zone_a, zone_b)


# ---------------------------------------------------------------------------
# Scale-out placement costs (replica autoscaling).
# ---------------------------------------------------------------------------

def marginal_park_w(device: DeviceInstance, context_on: bool) -> float:
    """Marginal power of holding ONE MORE warm replica on this device.

    The DVFS step is per-device: a device that already has a live
    context has paid it, so an extra replica parks for free there;
    a bare device pays its full step the moment the context comes up.
    This is the watt rate behind the over-provisioning parking tax."""
    return 0.0 if context_on else device.profile.dvfs_step_w


def above_base_load_j(device: DeviceInstance, loader) -> float:
    """Above-bare-idle energy of one (re)load on this device (the
    energy-exact reload cost the autoscaler's ski-rental tests use).
    Load watts resolve through ``DeviceProfile.load_power_w`` -- the
    loader's own number when it has one, the SKU's catalog ``p_load_w``
    otherwise -- the same rule the EnergyMeter prices LOADING with."""
    return max(device.profile.load_power_w(loader)
               - device.profile.p_base_w, 0.0) * loader.t_load_s


def wake_cost_j(device: DeviceInstance, hold_s: float = 0.0) -> float:
    """Marginal joules of WAKING this device for a placement versus
    leaving it gated: the wake ramp's above-sleep energy plus the
    bare-minus-sleep delta over the expected awake window.  Added to a
    sleeping candidate's cold-placement score by the energy-aware
    routers and the autoscaler (gated devices are cheap watts but not
    free first-token)."""
    return power_states.wake_penalty_j(device.profile, hold_s)


def wake_cost_kg(device: DeviceInstance, trace, now_s: float,
                 t_warm_s: float, hold_s: float) -> float:
    """kgCO2e analogue of ``wake_cost_j`` under a grid-intensity trace:
    the ramp burst priced at the [now, t_warm] window's mean intensity,
    the above-sleep hold INTEGRATED over its own window (the hold can
    span trace swings).  One formula for the carbon-aware router and
    autoscaler, so the two cannot drift apart."""
    prof = device.profile
    return (wake_cost_j(device, 0.0) * trace.mean(now_s, t_warm_s)
            + (prof.p_base_w - prof.p_sleep_w)
            * trace.integral(t_warm_s, t_warm_s + max(hold_s, 0.0))
            ) / 3.6e6


def scaleout_cost_j(device: DeviceInstance, loader, hold_s: float, *,
                    context_on: bool) -> float:
    """Expected joules of placing one more warm replica on ``device``:
    the above-bare load burst plus the marginal parking power held for
    ``hold_s`` (the planner caps hold_s at the device's breakeven
    window, so an always-idle replica is priced at one reload)."""
    return (above_base_load_j(device, loader)
            + marginal_park_w(device, context_on) * max(hold_s, 0.0))
