"""Phase-2 within-subject dose-response experiment harness (paper section 3.2).

Protocol per paper Table 1 / section 3.2, identical on every architecture:

  1. record bare-idle baseline (no context),
  2. create a persistent context (the DVFS step),
  3. for each VRAM level in an increasing ladder:
       allocate -> stabilize 60 s -> record n x 30 s -> release -> cool 30 s,
  4. fit OLS of phase-mean power on VRAM across context-active phases,
  5. TOST equivalence test against |beta| < 0.1 W/GB.

The harness only talks to the ``PowerReader`` interface, so the same code
drives the simulated oracle here and real SMI telemetry on hardware.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import stats
from repro_torch.core.power_model import DeviceProfile
from repro_torch.core.telemetry import PowerReader, SimulatedPowerReader


@dataclasses.dataclass(frozen=True)
class PhaseRecord:
    vram_gb: float
    context_active: bool
    mean_w: float
    std_w: float
    se_w: float
    n: int
    samples_w: np.ndarray


@dataclasses.dataclass(frozen=True)
class DoseResponse:
    """Full result of one device's dose-response experiment."""
    device: str
    bare_idle_w: float
    ctx_idle_w: float               # mean over CUDA-active phases
    dvfs_step_w: float
    power_range_w: float            # max-min across context-active phases
    regression: stats.OLSResult     # beta across context-active phases
    tost: stats.TOSTResult
    phases: List[PhaseRecord]

    @property
    def context_share_of_tax(self) -> float:
        """Fraction of the parking tax attributable to the context (>99%)."""
        vmax = max(p.vram_gb for p in self.phases)
        vram_component = abs(self.regression.slope) * vmax
        total = self.dvfs_step_w + vram_component
        return self.dvfs_step_w / total if total > 0 else 1.0


def default_vram_ladder(max_gb: float, n_levels: int = 9) -> List[float]:
    """0 .. max in even steps (paper: 0-64 H100 / 0-72 A100 / 0-40 L40S)."""
    return [round(v, 3) for v in np.linspace(0.0, max_gb, n_levels)]


def run_dose_response(
    reader: PowerReader,
    *,
    device_name: str,
    vram_levels_gb: Sequence[float],
    n_per_phase: int = 40,
    interval_s: float = 30.0,
    stabilize_s: float = 60.0,
    cooldown_s: float = 30.0,
    tost_bound_w_per_gb: float = 0.1,
) -> DoseResponse:
    """Execute the paper's Phase-2 protocol against any PowerReader."""
    t = 0.0
    phases: List[PhaseRecord] = []

    def record(context_active: bool, vram_gb: float) -> PhaseRecord:
        nonlocal t
        reader.set_state(context_active=context_active, vram_gb=vram_gb)
        t += stabilize_s
        samples = [reader.sample(t + i * interval_s) for i in range(n_per_phase)]
        t += n_per_phase * interval_s + cooldown_s
        p = np.array([s.power_w for s in samples])
        mean, sd, se = stats.phase_mean_se(p)
        return PhaseRecord(vram_gb=vram_gb, context_active=context_active,
                           mean_w=mean, std_w=sd, se_w=se, n=n_per_phase,
                           samples_w=p)

    # 1. bare idle baseline (no context)
    phases.append(record(context_active=False, vram_gb=0.0))
    # 2-3. context active, increasing VRAM ladder (within-subject)
    for v in vram_levels_gb:
        phases.append(record(context_active=True, vram_gb=float(v)))

    ctx_phases = [p for p in phases if p.context_active]
    x = np.array([p.vram_gb for p in ctx_phases])
    y = np.array([p.mean_w for p in ctx_phases])
    reg = stats.ols(x, y)
    tost = stats.tost_slope(reg, bound=tost_bound_w_per_gb)

    bare = phases[0].mean_w
    ctx_mean = float(y.mean())
    return DoseResponse(
        device=device_name,
        bare_idle_w=bare,
        ctx_idle_w=ctx_mean,
        dvfs_step_w=ctx_mean - bare,
        power_range_w=float(y.max() - y.min()),
        regression=reg,
        tost=tost,
        phases=phases,
    )


def run_simulated_dose_response(
    profile: DeviceProfile,
    *,
    seed: int = 0,
    thermal_drift_w_per_hr: float = 0.0,
    n_levels: int = 9,
    n_per_phase: int = 40,
) -> DoseResponse:
    """Phase-2 experiment against the paper-physics oracle for ``profile``."""
    reader = SimulatedPowerReader(
        profile, seed=seed, thermal_drift_w_per_hr=thermal_drift_w_per_hr)
    ladder = default_vram_ladder(profile.max_vram_tested_gb, n_levels=n_levels)
    return run_dose_response(reader, device_name=profile.name,
                             vram_levels_gb=ladder, n_per_phase=n_per_phase)


def table2_row(dr: DoseResponse, profile: DeviceProfile) -> dict:
    """One column of paper Table 2, from a DoseResponse result."""
    return {
        "device": dr.device,
        "memory": profile.memory_tech,
        "bare_idle_w": round(dr.bare_idle_w, 1),
        "ctx_power_w": round(dr.ctx_idle_w, 1),
        "context_overhead_w": round(dr.dvfs_step_w, 1),
        "context_pct_tdp": round(100.0 * dr.dvfs_step_w / profile.tdp_w, 1),
        "max_vram_gb": max(p.vram_gb for p in dr.phases),
        "power_range_w": round(dr.power_range_w, 2),
        "beta_w_per_gb": round(dr.regression.slope, 4),
        "beta_ci": (round(dr.regression.ci_low, 4),
                    round(dr.regression.ci_high, 4)),
        "p_beta": dr.regression.p_value,
        "p_tost": dr.tost.p_tost,
        "context_share_pct": round(100.0 * dr.context_share_of_tax, 1),
    }
