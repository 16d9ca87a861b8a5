"""Telemetry substrate: power sampling interfaces + the simulated oracle.

The paper's measurements come from nvidia-smi / DCGM at 30 s cadence.  This
module provides the hardware-agnostic ``PowerReader`` interface the
dose-response harness and the serving EnergyMeter consume, plus a
``SimulatedPowerReader`` whose *ground truth is the paper's physics*:

  * idle power is exactly Eq. 1 with the profile's (true) beta,
  * within-phase noise is AR(1) with the per-device sigma of section 3.3
    (tau ~ 6-10 samples of thermal correlation, Eq. 6),
  * an optional slow thermal drift reproduces the A100's confounded
    negative slope (section 4.2: -0.09 W over 72 GB <-> 0.7 C HBM drift),
  * per-instance intercept offsets reproduce the ~23 W inter-node spread.

On real hardware one would register an SMI/DCGM-backed reader with the same
interface; nothing downstream changes (DESIGN.md section 3).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.power_model import DeviceProfile


@dataclasses.dataclass(frozen=True)
class PowerSample:
    t_s: float              # seconds since epoch of the experiment
    power_w: float
    util_pct: float
    vram_gb: float
    sm_clock_mhz: float
    temp_c: float
    device: str
    context_active: bool


class PowerReader(Protocol):
    """One accelerator's telemetry stream (30 s cadence by default)."""

    def sample(self, t_s: float) -> PowerSample: ...

    def set_state(self, *, context_active: bool, vram_gb: float) -> None: ...


class SimulatedPowerReader:
    """Paper-physics oracle for one device instance.

    AR(1) noise: x_t = rho * x_{t-1} + sqrt(1-rho^2) * sigma * eps_t keeps the
    *stationary* std at sigma while giving the thermal autocorrelation time
    tau = -1/ln(rho) samples (paper Eq. 6 uses tau ~ 6-10 at 30 s cadence).
    """

    def __init__(
        self,
        profile: DeviceProfile,
        *,
        seed: int = 0,
        instance_offset_w: float = 0.0,
        thermal_drift_w_per_hr: float = 0.0,
        ar_tau_samples: float = 8.0,
        base_temp_c: float = 50.0,
    ) -> None:
        self.profile = profile.with_instance_offset(instance_offset_w)
        self._rng = np.random.default_rng(seed)
        self._rho = float(np.exp(-1.0 / ar_tau_samples))
        self._noise_state = 0.0
        self._drift_w_per_s = thermal_drift_w_per_hr / 3600.0
        self._base_temp_c = base_temp_c
        self._context_active = False
        self._vram_gb = 0.0
        self._util = 0.0

    # -- state the experiment manipulates ---------------------------------
    def set_state(self, *, context_active: bool, vram_gb: float,
                  util: float = 0.0) -> None:
        if vram_gb < 0 or vram_gb > self.profile.vram_capacity_gb:
            raise ValueError(
                f"vram {vram_gb} GB out of range for {self.profile.name} "
                f"(capacity {self.profile.vram_capacity_gb} GB)")
        self._context_active = context_active
        self._vram_gb = vram_gb
        self._util = util

    # -- telemetry ---------------------------------------------------------
    def sample(self, t_s: float) -> PowerSample:
        sigma = self.profile.sigma_w
        eps = self._rng.standard_normal()
        self._noise_state = (self._rho * self._noise_state
                             + np.sqrt(1.0 - self._rho ** 2) * sigma * eps)
        if self._util > 0:
            mean = self.profile.active_power_w(self._util)
        else:
            mean = self.profile.idle_power_w(self._context_active, self._vram_gb)
        # slow monotone thermal drift (models the A100 cooling transient that
        # confounds a sequential dose ladder into a tiny negative slope)
        drift = -self._drift_w_per_s * t_s
        power = mean + drift + self._noise_state
        clock = (self.profile.sm_clock_ctx_mhz if self._context_active
                 else self.profile.sm_clock_idle_mhz)
        # 0.7 C drift over the ladder scaled off the power drift
        temp = self._base_temp_c + drift * 0.5
        return PowerSample(
            t_s=t_s, power_w=float(power), util_pct=float(self._util * 100.0),
            vram_gb=self._vram_gb, sm_clock_mhz=clock, temp_c=float(temp),
            device=self.profile.name, context_active=self._context_active,
        )

    def record_phase(self, *, t0_s: float, n: int,
                     interval_s: float = 30.0) -> List[PowerSample]:
        """Record n samples at fixed cadence (one dose-response phase)."""
        return [self.sample(t0_s + i * interval_s) for i in range(n)]


# ---------------------------------------------------------------------------
# Phase 1: production fleet telemetry (14 H100s, 18 days, 30 s cadence).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetDataset:
    """Column-oriented Phase-1 dataset (numpy arrays, one row per sample)."""
    power_w: np.ndarray
    util_pct: np.ndarray
    vram_gb: np.ndarray
    sm_clock_mhz: np.ndarray
    gpu_id: np.ndarray
    context_active: np.ndarray      # bool

    def __len__(self) -> int:
        return int(self.power_w.shape[0])

    def idle_only(self) -> "FleetDataset":
        """Filter to 0% utilization (paper: 335,267 of 336,226 = 99.7%)."""
        m = self.util_pct == 0.0
        return FleetDataset(*(getattr(self, f.name)[m]
                              for f in dataclasses.fields(self)))


# Production-fleet H100 (paper Phase 1): SXM nodes idle hotter than the
# Phase-2 bench unit -- bare 74.7 W, CUDA-active 145.5 W (+70.9 W effect).
PHASE1_H100 = DeviceProfile(
    name="H100-80GB-SXM-prod", memory_tech="HBM3", tdp_w=700.0,
    p_base_w=74.7, p_ctx_w=145.5,
    sm_clock_idle_mhz=345.0, sm_clock_ctx_mhz=1980.0,
    vram_capacity_gb=80.0, max_vram_tested_gb=79.0,
    beta_w_per_gb=0.0, sigma_w=0.17, mem_bw_gbps=3350.0,
)

# the "five workload categories" of section 3.1: parked model footprints
_VRAM_CATEGORIES = (0.003, 5.0, 15.0, 40.0, 79.0)


def simulate_fleet(
    profile: DeviceProfile = PHASE1_H100,
    *,
    n_gpus: int = 14,
    n_total: int = 336_226,
    n_busy: int = 959,                 # non-idle samples filtered out (0.3%)
    intercept_spread_w: float = 6.0,   # node binning/cooling (~23 W range)
    bare_std_w: float = 7.9,           # paper per-state stds (sec 4.1)
    ctx_std_w: float = 11.2,
    n_epochs: int = 24,                # VRAM reallocation epochs per GPU
    seed: int = 7,
) -> FleetDataset:
    """Generate the Phase-1 production telemetry per the paper's description.

    Half the fleet holds a context (CUDA-active at max boost), half is bare
    idle; each GPU's VRAM allocation changes across epochs over the 18
    days, drawn from five workload categories spanning 3 MB .. 79 GB; the
    TRUE VRAM slope is the profile's beta (0).  Per-state total variance =
    per-node intercept spread (binning/cooling) + AR(1) sampling noise,
    matching the reported stds (7.9 W bare / 11.2 W active).
    """
    rng = np.random.default_rng(seed)
    per_gpu = n_total // n_gpus
    counts = np.full(n_gpus, per_gpu)
    counts[: n_total - per_gpu * n_gpus] += 1

    offsets = rng.normal(0.0, intercept_spread_w, size=n_gpus)
    ctx_flags = np.arange(n_gpus) % 2 == 0         # 7 active / 7 bare

    cols_p, cols_u, cols_v, cols_c, cols_g, cols_ctx = [], [], [], [], [], []
    for g in range(n_gpus):
        n = counts[g]
        total_std = ctx_std_w if ctx_flags[g] else bare_std_w
        sigma = np.sqrt(max(total_std ** 2 - intercept_spread_w ** 2, 1.0))
        rho = np.exp(-1.0 / 8.0)
        eps = rng.standard_normal(n) * sigma * np.sqrt(1 - rho ** 2)
        noise = np.empty(n)
        acc = rng.standard_normal() * sigma
        for i in range(n):
            acc = rho * acc + eps[i]
            noise[i] = acc
        # VRAM epochs: allocation changes as workloads come and go
        epoch_len = max(n // n_epochs, 1)
        vram = np.repeat(
            rng.choice(_VRAM_CATEGORIES, size=n_epochs + 1), epoch_len)[:n]
        base = np.array([profile.idle_power_w(bool(ctx_flags[g]), float(v))
                         for v in vram])
        power = base + offsets[g] + noise
        clock = (profile.sm_clock_ctx_mhz if ctx_flags[g]
                 else profile.sm_clock_idle_mhz)
        cols_p.append(power)
        cols_u.append(np.zeros(n))
        cols_v.append(vram)
        cols_c.append(np.full(n, clock))
        cols_g.append(np.full(n, g))
        cols_ctx.append(np.full(n, ctx_flags[g], dtype=bool))

    ds = FleetDataset(
        power_w=np.concatenate(cols_p),
        util_pct=np.concatenate(cols_u),
        vram_gb=np.concatenate(cols_v),
        sm_clock_mhz=np.concatenate(cols_c),
        gpu_id=np.concatenate(cols_g),
        context_active=np.concatenate(cols_ctx),
    )
    # sprinkle the 959 busy samples (avg util 0.11% over the full set)
    busy_idx = rng.choice(len(ds), size=n_busy, replace=False)
    ds.util_pct[busy_idx] = rng.uniform(1.0, 80.0, size=n_busy)
    ds.power_w[busy_idx] += rng.uniform(20.0, 400.0, size=n_busy)
    return ds
