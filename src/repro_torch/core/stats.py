"""Statistics for the dose-response analysis (paper sections 3.3, 4.1, 4.2).

Implements exactly the tests the paper reports:
  * OLS slope with exact-t confidence intervals and two-sided p  (Table 2 beta)
  * Schuirmann TOST equivalence test against |beta| < bound     (Table 2 p_TOST)
  * Welch two-sample t and Cohen's d                            (Phase 1, d=7.3)
  * autocorrelation-corrected effective sample size             (Eq. 6)

scipy is available in this container; we use its t/norm CDFs and keep the
estimators themselves explicit so they are auditable against the paper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import stats as sps


@dataclasses.dataclass(frozen=True)
class OLSResult:
    slope: float
    intercept: float
    stderr: float                # SE of slope
    ci_low: float                # 95% CI of slope
    ci_high: float
    p_value: float               # two-sided, H0: slope = 0
    r2: float
    n: int
    dof: int

    def summary(self) -> str:
        return (f"beta={self.slope:+.4f} [{self.ci_low:+.4f},{self.ci_high:+.4f}] "
                f"p={self.p_value:.3g} R2={self.r2:.3f} n={self.n}")


def ols(x: np.ndarray, y: np.ndarray, *, dof_override: Optional[int] = None
        ) -> OLSResult:
    """Simple linear regression y = a + b x with exact-t inference.

    ``dof_override`` lets callers substitute the autocorrelation-corrected
    effective sample size (Eq. 6) for inference on serially-correlated
    telemetry (paper section 3.1) without changing the point estimate.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape or x.ndim != 1:
        raise ValueError("x and y must be 1-D arrays of equal length")
    n = x.size
    if n < 3:
        raise ValueError("need >= 3 points for OLS inference")
    xbar, ybar = x.mean(), y.mean()
    sxx = float(((x - xbar) ** 2).sum())
    if sxx == 0.0:
        raise ValueError("x has zero variance")
    sxy = float(((x - xbar) * (y - ybar)).sum())
    slope = sxy / sxx
    intercept = ybar - slope * xbar
    resid = y - (intercept + slope * x)
    sse = float((resid ** 2).sum())
    sst = float(((y - ybar) ** 2).sum())
    dof = (dof_override if dof_override is not None else n) - 2
    dof = max(dof, 1)
    s2 = sse / dof
    se = math.sqrt(s2 / sxx)
    tcrit = float(sps.t.ppf(0.975, dof))
    tstat = slope / se if se > 0 else math.inf
    p = float(2.0 * sps.t.sf(abs(tstat), dof))
    r2 = 1.0 - (sse / sst if sst > 0 else 0.0)
    return OLSResult(slope=slope, intercept=intercept, stderr=se,
                     ci_low=slope - tcrit * se, ci_high=slope + tcrit * se,
                     p_value=p, r2=r2, n=n, dof=dof)


@dataclasses.dataclass(frozen=True)
class TOSTResult:
    """Schuirmann two one-sided tests for equivalence |slope| < bound."""
    bound: float
    p_lower: float     # H0: slope <= -bound  vs  H1: slope > -bound
    p_upper: float     # H0: slope >= +bound  vs  H1: slope < +bound
    p_tost: float      # max of the two (the TOST decision p)
    equivalent: bool   # p_tost < alpha


def tost_slope(res: OLSResult, *, bound: float = 0.1, alpha: float = 0.05
               ) -> TOSTResult:
    """Equivalence test on a regression slope (paper Table 2, D=0.1 W/GB).

    Rejecting both one-sided nulls establishes |beta| < bound: "bounded below
    practical relevance" rather than merely failing to detect an effect.
    """
    if bound <= 0:
        raise ValueError("equivalence bound must be positive")
    t_lo = (res.slope + bound) / res.stderr
    t_hi = (res.slope - bound) / res.stderr
    p_lower = float(sps.t.sf(t_lo, res.dof))    # want slope > -bound
    p_upper = float(sps.t.cdf(t_hi, res.dof))   # want slope < +bound
    p = max(p_lower, p_upper)
    return TOSTResult(bound=bound, p_lower=p_lower, p_upper=p_upper,
                      p_tost=p, equivalent=bool(p < alpha))


@dataclasses.dataclass(frozen=True)
class TwoSampleResult:
    mean_a: float
    mean_b: float
    std_a: float
    std_b: float
    diff: float
    cohens_d: float
    t_stat: float
    p_value: float
    n_a: int
    n_b: int


def welch_cohens(a: np.ndarray, b: np.ndarray) -> TwoSampleResult:
    """Welch t-test + pooled-SD Cohen's d (paper 4.1: d = 7.3, p < 1e-300)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ma, mb = a.mean(), b.mean()
    sa, sb = a.std(ddof=1), b.std(ddof=1)
    na, nb = a.size, b.size
    se = math.sqrt(sa ** 2 / na + sb ** 2 / nb)
    t = (mb - ma) / se if se > 0 else math.inf
    # Welch-Satterthwaite dof
    num = (sa ** 2 / na + sb ** 2 / nb) ** 2
    den = (sa ** 2 / na) ** 2 / (na - 1) + (sb ** 2 / nb) ** 2 / (nb - 1)
    dof = num / den if den > 0 else na + nb - 2
    p = float(2.0 * sps.t.sf(abs(t), dof))
    pooled = math.sqrt(((na - 1) * sa ** 2 + (nb - 1) * sb ** 2) / (na + nb - 2))
    d = (mb - ma) / pooled if pooled > 0 else math.inf
    return TwoSampleResult(mean_a=float(ma), mean_b=float(mb), std_a=float(sa),
                           std_b=float(sb), diff=float(mb - ma),
                           cohens_d=float(d), t_stat=float(t), p_value=p,
                           n_a=na, n_b=nb)


def effective_sample_size(n_raw: int, tau_samples: float) -> float:
    """Paper Eq. 6: N_eff ~ N_raw / (2 tau + 1) for AR-correlated telemetry."""
    if tau_samples < 0:
        raise ValueError("tau must be >= 0")
    return n_raw / (2.0 * tau_samples + 1.0)


def autocorr_time(x: np.ndarray, *, max_lag: int = 200) -> float:
    """Integrated autocorrelation time (in samples) via initial-positive-sum.

    Used to estimate tau from raw telemetry rather than assuming it; the
    paper quotes tau ~ 6-10 samples for 3-5 min thermal correlation at 30 s.
    """
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = x.size
    if n < 4:
        return 0.0
    var = float(np.dot(x, x)) / n
    if var == 0:
        return 0.0
    tau = 0.0
    for lag in range(1, min(max_lag, n - 1)):
        c = float(np.dot(x[:-lag], x[lag:])) / (n - lag) / var
        if c <= 0.05:
            break
        tau += c
    return tau


def phase_mean_se(samples: np.ndarray) -> Tuple[float, float, float]:
    """(mean, within-phase std, SE of mean) for one recording phase (Eq. 7)."""
    samples = np.asarray(samples, dtype=np.float64)
    m = float(samples.mean())
    sd = float(samples.std(ddof=1)) if samples.size > 1 else 0.0
    se = sd / math.sqrt(samples.size) if samples.size > 0 else 0.0
    return m, sd, se
