"""Synthetic request traffic (paper section 7) + beyond-paper heavy-tail traces.

All generators return a sorted np.ndarray of arrival times in seconds over
[0, horizon_s).  The paper evaluates three patterns on a 24 h horizon:

  * steady Poisson, 5 req/hr
  * bursty: alternating 2 and 60 req/hr
  * diurnal: sinusoidal with 30 req/hr peak

We add an MMPP (Markov-modulated Poisson) heavy-tail generator, since the
paper's Future Work calls out that synthetic Poisson/diurnal traces miss
the burstiness of production traffic.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


def poisson(rate_per_hr: float, horizon_s: float = DAY, *,
            seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals."""
    rng = np.random.default_rng(seed)
    rate_per_s = rate_per_hr / HOUR
    if rate_per_s <= 0:
        return np.empty(0)
    # draw expected count + slack, then trim
    n = int(rate_per_s * horizon_s * 1.5 + 50)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    t = np.cumsum(gaps)
    return t[t < horizon_s]


def inhomogeneous(rate_fn: Callable[[float], float], rate_max_per_hr: float,
                  horizon_s: float = DAY, *, seed: int = 0) -> np.ndarray:
    """Thinning (Lewis-Shedler) for a time-varying rate, rate in req/hr."""
    rng = np.random.default_rng(seed)
    lam_max = rate_max_per_hr / HOUR
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= horizon_s:
            break
        if rng.uniform() < rate_fn(t) / rate_max_per_hr:
            out.append(t)
    return np.asarray(out)


def bursty(low_per_hr: float = 2.0, high_per_hr: float = 60.0,
           low_s: float = 2 * HOUR, high_s: float = HOUR,
           horizon_s: float = DAY, *, seed: int = 0) -> np.ndarray:
    """Alternating low/high Poisson phases (paper: 2 / 60 req/hr).

    The paper does not state the phase duty cycle; a 2 h-low / 1 h-high
    alternation reproduces its Table-6 bursty row (~480-510 requests/day,
    ~48 cold starts, ~23% breakeven savings, ~4.5 s mean added latency) --
    see EXPERIMENTS.md "trace construction" note.
    """
    period = low_s + high_s
    def rate(t: float) -> float:
        return low_per_hr if (t % period) < low_s else high_per_hr
    return inhomogeneous(rate, max(low_per_hr, high_per_hr), horizon_s,
                         seed=seed)


def diurnal(peak_per_hr: float = 30.0, horizon_s: float = DAY, *,
            seed: int = 0) -> np.ndarray:
    """Sinusoidal daily cycle, 0 .. peak (paper: peak 30 req/hr)."""
    def rate(t: float) -> float:
        return 0.5 * peak_per_hr * (1.0 - np.cos(2.0 * np.pi * t / DAY))
    return inhomogeneous(rate, peak_per_hr, horizon_s, seed=seed)


def mmpp(rates_per_hr=(1.0, 40.0, 400.0), mean_dwell_s=(2 * HOUR, 20 * 60, 90),
         horizon_s: float = DAY, *, seed: int = 0) -> np.ndarray:
    """Markov-modulated Poisson: heavy-tailed production-like burstiness.

    Beyond-paper: used to stress-test eviction policies outside the paper's
    three benign patterns (see EXPERIMENTS.md, Beyond-paper section).
    """
    rng = np.random.default_rng(seed)
    k = len(rates_per_hr)
    t, state, out = 0.0, 0, []
    while t < horizon_s:
        dwell = rng.exponential(mean_dwell_s[state])
        seg_end = min(t + dwell, horizon_s)
        lam = rates_per_hr[state] / HOUR
        tt = t
        while lam > 0:
            tt += rng.exponential(1.0 / lam)
            if tt >= seg_end:
                break
            out.append(tt)
        t = seg_end
        state = int(rng.integers(0, k))
    return np.asarray(sorted(out))


PATTERNS = {
    "steady": lambda seed=0: poisson(5.0, seed=seed),
    "bursty": lambda seed=0: bursty(seed=seed),
    "diurnal": lambda seed=0: diurnal(seed=seed),
    "mmpp": lambda seed=0: mmpp(seed=seed),
}
