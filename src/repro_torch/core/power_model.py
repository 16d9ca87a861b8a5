"""Piecewise-constant idle power model (paper Eq. 1).

    P_idle(C, V) = P_base + dP_DVFS * 1[C=1] + beta * V

The paper's central empirical finding is that ``beta ~ 0`` (|beta| < 0.02 W/GB,
TOST-bounded below 0.1 W/GB) on every architecture tested, while the
context/runtime-residency step ``dP_DVFS`` is +26-66 W.  The model therefore
degenerates to a step function of context presence.

``DeviceProfile`` carries every hardware constant the rest of the framework
consumes (breakeven times, eviction thresholds, simulator energy accounting,
industry impact).  The three GPU profiles are the paper's Table 2 columns and
act as ground truth for reproducing the paper; the TPU profile is a documented
estimate (``estimated=True``) for the TPU-native serving framework -- see
DESIGN.md section 3 (hardware adaptation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Static power/clock characterisation of one accelerator model.

    All wattages are chip-level board power as a telemetry counter would
    report them (nvidia-smi / TPU runtime metrics).
    """

    name: str
    memory_tech: str                 # "HBM3" | "HBM2e" | "GDDR6" | ...
    tdp_w: float
    p_base_w: float                  # bare idle, no runtime context
    p_ctx_w: float                   # idle with a live context (0% util)
    sm_clock_idle_mhz: float
    sm_clock_ctx_mhz: float
    vram_capacity_gb: float
    max_vram_tested_gb: float        # dose-response ladder ceiling (paper Tab.1)
    beta_w_per_gb: float = 0.0       # TRUE marginal VRAM slope (physics: ~0)
    sigma_w: float = 0.1             # within-phase sampling noise (paper 3.3)
    mem_bw_gbps: float = 0.0         # memory bandwidth, for roofline/loading
    estimated: bool = False          # True when not measured by the paper
    # -- load-phase watts (per-SKU fallback when no LoaderSpec applies;
    #    replaces the old hardcoded `p_base_w + 30.0`); None derives it
    p_load_w: Optional[float] = None
    # -- sleep/wake gating (core/power_states.py): the paper never powers
    #    a device down, so these are ENGINEERING ESTIMATES (GPU
    #    persistence off / deep-idle rail state; wake = software re-init +
    #    clock bring-up).  None derives conservative defaults from the
    #    bare-idle power.
    p_sleep_w: Optional[float] = None    # gated floor while asleep
    wake_latency_s: float = 10.0         # SLEEP -> BARE ramp duration
    wake_energy_j: Optional[float] = None  # TOTAL joules of the wake ramp

    def __post_init__(self):
        if self.p_load_w is None:
            object.__setattr__(self, "p_load_w", self.p_base_w + 30.0)
        if self.p_sleep_w is None:
            object.__setattr__(self, "p_sleep_w", 0.2 * self.p_base_w)
        if self.wake_energy_j is None:
            object.__setattr__(self, "wake_energy_j",
                               2.5 * self.p_base_w * self.wake_latency_s)

    @property
    def dvfs_step_w(self) -> float:
        """The parking tax ``dP_DVFS`` = context overhead (paper Table 2)."""
        return self.p_ctx_w - self.p_base_w

    @property
    def ctx_pct_tdp(self) -> float:
        return self.dvfs_step_w / self.tdp_w

    def idle_power_w(self, context_active: bool, vram_gb: float = 0.0) -> float:
        """Paper Eq. 1 (deterministic part)."""
        p = self.p_base_w
        if context_active:
            p += self.dvfs_step_w
        return p + self.beta_w_per_gb * vram_gb

    def active_power_w(self, utilization: float) -> float:
        """Crude active-compute model: linear ramp ctx-idle -> TDP.

        Only used for *relative* accounting in the serving simulator; the
        paper's scheduler study holds request-service energy constant across
        policies (always-on 24h energy == p_ctx * 24h in Table 6).
        """
        utilization = min(max(utilization, 0.0), 1.0)
        return self.p_ctx_w + utilization * (self.tdp_w - self.p_ctx_w)

    def load_power_w(self, loader=None) -> float:
        """Load-phase watts: the loading method's own measured/derived
        power when a ``LoaderSpec`` is given, else this SKU's catalog
        ``p_load_w`` (one resolution rule for the meter and
        ``fleet.catalog.above_base_load_j``)."""
        if loader is not None:
            return loader.p_load_w
        return self.p_load_w

    def with_instance_offset(self, offset_w: float) -> "DeviceProfile":
        """Same silicon, different node: intercepts vary (~23 W in Phase 1,
        e.g. the Table 3 A100 idling at 105 W vs. 80 W in Phase 2); slopes
        do not.  Every idle-anchored level rides the intercept -- P_base,
        P_ctx, the loading fallback, the sleep floor, and the wake ramp
        (offset x t_wake) -- so the DVFS step, the above-base load delta,
        and the gating breakeven T*_gate are all preserved."""
        return dataclasses.replace(
            self,
            p_base_w=self.p_base_w + offset_w,
            p_ctx_w=self.p_ctx_w + offset_w,
            p_load_w=self.p_load_w + offset_w,
            p_sleep_w=self.p_sleep_w + offset_w,
            wake_energy_j=self.wake_energy_j
            + offset_w * self.wake_latency_s,
        )


# ---------------------------------------------------------------------------
# Paper Table 2 ground-truth profiles (measured; these are the reproduction
# targets) + the TPU adaptation profile (estimated; see DESIGN.md section 3).
# Sleep/wake constants are engineering estimates in every profile (the
# paper never gates a device): sleep = persistence-off deep idle, wake =
# software re-init + clock bring-up, sized so the device-level gating
# breakeven (power_states.gate_breakeven_s) lands around ~30 s.
# ---------------------------------------------------------------------------

H100 = DeviceProfile(
    name="H100-80GB-SXM", memory_tech="HBM3", tdp_w=700.0,
    p_base_w=71.8, p_ctx_w=121.7,
    sm_clock_idle_mhz=345.0, sm_clock_ctx_mhz=1980.0,
    vram_capacity_gb=80.0, max_vram_tested_gb=64.0,
    beta_w_per_gb=0.0, sigma_w=0.17, mem_bw_gbps=3350.0,
    p_load_w=124.1,              # paper's measured Qwen2.5-7B load mean
    p_sleep_w=14.0, wake_latency_s=10.0, wake_energy_j=2500.0,
)

A100 = DeviceProfile(
    name="A100-80GB-PCIe", memory_tech="HBM2e", tdp_w=300.0,
    p_base_w=53.7, p_ctx_w=80.0,
    sm_clock_idle_mhz=210.0, sm_clock_ctx_mhz=1410.0,
    vram_capacity_gb=80.0, max_vram_tested_gb=72.0,
    beta_w_per_gb=0.0, sigma_w=0.08, mem_bw_gbps=2000.0,
    p_load_w=96.0,
    p_sleep_w=11.0, wake_latency_s=8.0, wake_energy_j=1600.0,
)

L40S = DeviceProfile(
    name="L40S-48GB", memory_tech="GDDR6", tdp_w=350.0,
    p_base_w=35.6, p_ctx_w=102.1,
    sm_clock_idle_mhz=210.0, sm_clock_ctx_mhz=2520.0,
    vram_capacity_gb=48.0, max_vram_tested_gb=40.0,
    beta_w_per_gb=0.0, sigma_w=1.2, mem_bw_gbps=864.0,
    p_load_w=118.0,
    p_sleep_w=8.0, wake_latency_s=6.0, wake_energy_j=1000.0,
)

# TPU v5e: the CUDA-context mechanism does not exist on TPU; the analogue is
# PJRT-client/program residency keeping the chip out of deep idle.  Constants
# are engineering estimates for a ~200 W-class chip (819 GB/s HBM, 197 bf16
# TFLOP/s) and are NOT paper measurements -- flagged `estimated`.
TPU_V5E = DeviceProfile(
    name="TPU-v5e", memory_tech="HBM2e", tdp_w=200.0,
    p_base_w=55.0, p_ctx_w=90.0,
    sm_clock_idle_mhz=0.0, sm_clock_ctx_mhz=0.0,
    vram_capacity_gb=16.0, max_vram_tested_gb=16.0,
    beta_w_per_gb=0.0, sigma_w=0.2, mem_bw_gbps=819.0,
    estimated=True,
    p_load_w=100.0,
    p_sleep_w=12.0, wake_latency_s=12.0, wake_energy_j=2000.0,
)

PROFILES: Dict[str, DeviceProfile] = {
    "h100": H100,
    "a100": A100,
    "l40s": L40S,
    "tpu_v5e": TPU_V5E,
}


def get_profile(name: str) -> DeviceProfile:
    key = name.lower().replace("-", "_")
    if key not in PROFILES:
        raise KeyError(f"unknown device profile {name!r}; have {sorted(PROFILES)}")
    return PROFILES[key]
