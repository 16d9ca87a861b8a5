"""The port's measurement and policy modules against the JAX package's.

``repro_torch.core.{stats,telemetry,doseresponse,phase1,simulator}``
are the reference's numpy/scipy code with their imports rewritten, so
on the reference's own test cases they must give the reference's
numbers exactly (``==``, no tolerance).  Then the single-device anchor
on the port: one device, one model through ``run_fleet`` and through
``run_mega(backend="torch")`` (on the CPU here) reproduces
``core.simulator.simulate`` to 1e-6 Wh, and always-on H100 for 24 h is
2920.8 Wh (121.7 W x 24 h).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import A100 as RefA100
from repro.core import H100 as RefH100
from repro.core import L40S as RefL40S
from repro.core import PYTORCH_70B as RefPYTORCH_70B
from repro.core import doseresponse as ref_doseresponse
from repro.core import phase1 as ref_phase1
from repro.core import scheduler as ref_scheduler
from repro.core import simulator as ref_simulator
from repro.core import stats as ref_stats
from repro.core import telemetry as ref_telemetry
from repro.core import traffic as ref_traffic
from repro_torch.core import (A100, H100, L40S, PYTORCH_70B, compare_policies,
                              doseresponse, phase1, scheduler, simulate,
                              stats, telemetry, traffic)
from repro_torch.fleet import run_fleet, run_mega, single_device_scenario

PATTERNS = ("steady", "bursty", "diurnal", "mmpp")

# (name, port policy factory, reference policy factory)
POLICIES = (
    ("always-on", scheduler.AlwaysOn, ref_scheduler.AlwaysOn),
    ("breakeven", lambda: scheduler.Breakeven(PYTORCH_70B, H100),
     lambda: ref_scheduler.Breakeven(RefPYTORCH_70B, RefH100)),
    ("ttl-5min", lambda: scheduler.FixedTTL(300.0),
     lambda: ref_scheduler.FixedTTL(300.0)),
)
POLICY_IDS = [p[0] for p in POLICIES]

PROFILES = ((H100, RefH100), (A100, RefA100), (L40S, RefL40S))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _ar1(rng, n=20_000):
    rho = np.exp(-1.0 / 8.0)
    x = np.empty(n)
    acc = 0.0
    eps = rng.normal(0, 1, n) * np.sqrt(1 - rho ** 2)
    for i in range(n):
        acc = rho * acc + eps[i]
        x[i] = acc
    return x


def _fields(obj):
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# stats: the cases of tests/test_core_stats.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["slope", "flat", "exact"])
def test_ols_and_tost_equal_reference(case):
    rng = _rng(1)
    x = np.linspace(0, 64, 80)
    if case == "slope":
        y = 100.0 + 0.5 * x + rng.normal(0, 0.1, size=80)
    elif case == "flat":
        y = 100.0 + rng.normal(0, 0.1, size=80)
    else:
        y = 3.0 - 0.25 * x
        y[0] += 1e-9
    got, want = stats.ols(x, y), ref_stats.ols(x, y)
    assert _fields(got) == _fields(want)
    for bound in (0.1, 0.02):
        assert _fields(stats.tost_slope(got, bound=bound)) == \
            _fields(ref_stats.tost_slope(want, bound=bound))
    assert _fields(stats.ols(x, y, dof_override=12)) == \
        _fields(ref_stats.ols(x, y, dof_override=12))


def test_welch_cohens_equal_reference():
    rng = _rng(2)
    bare = rng.normal(74.7, 7.9, size=5000)
    ctx = rng.normal(145.5, 11.2, size=5000)
    got = stats.welch_cohens(bare, ctx)
    assert _fields(got) == _fields(ref_stats.welch_cohens(bare, ctx))
    assert 6.5 < got.cohens_d < 8.2                   # paper: 7.3


def test_effective_sample_size_and_autocorr_equal_reference():
    for n, tau in ((335_267, 10.0), (335_267, 6.0), (17, 0.0), (1000, 50.0)):
        assert stats.effective_sample_size(n, tau) == \
            ref_stats.effective_sample_size(n, tau)
    x = _ar1(_rng(3))
    for lag in (200, 50):
        assert stats.autocorr_time(x, max_lag=lag) == \
            ref_stats.autocorr_time(x, max_lag=lag)


def test_phase_mean_se_equal_reference():
    for n in (1, 2, 40, 333):
        p = _rng(n).normal(120.0, 3.0, size=n)
        assert stats.phase_mean_se(p) == ref_stats.phase_mean_se(p)


# ---------------------------------------------------------------------------
# telemetry + dose-response (Table 2) + phase 1: tests/test_core_power.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("prof", PROFILES, ids=["h100", "a100", "l40s"])
def test_dose_response_table2_rows_equal_reference(prof, seed):
    port, ref = prof
    got = doseresponse.run_simulated_dose_response(port, seed=seed)
    want = ref_doseresponse.run_simulated_dose_response(ref, seed=seed)
    assert doseresponse.table2_row(got, port) == \
        ref_doseresponse.table2_row(want, ref)
    assert _fields(got.regression) == _fields(want.regression)
    assert _fields(got.tost) == _fields(want.tost)
    assert got.context_share_of_tax == want.context_share_of_tax
    assert len(got.phases) == len(want.phases)
    for a, b in zip(got.phases, want.phases):
        assert (a.vram_gb, a.context_active, a.mean_w, a.std_w, a.se_w,
                a.n) == (b.vram_gb, b.context_active, b.mean_w, b.std_w,
                         b.se_w, b.n)
        assert np.array_equal(a.samples_w, b.samples_w)


def test_dose_response_with_drift_and_injected_slope_equals_reference():
    hot = dataclasses.replace(H100, beta_w_per_gb=0.5)
    ref_hot = dataclasses.replace(RefH100, beta_w_per_gb=0.5)
    for drift in (0.0, 2.0):
        got = doseresponse.run_simulated_dose_response(
            hot, seed=1, thermal_drift_w_per_hr=drift)
        want = ref_doseresponse.run_simulated_dose_response(
            ref_hot, seed=1, thermal_drift_w_per_hr=drift)
        assert doseresponse.table2_row(got, hot) == \
            ref_doseresponse.table2_row(want, ref_hot)
        if drift == 0.0:              # the pipeline finds an injected slope
            assert got.regression.slope == pytest.approx(0.5, abs=0.05)
    assert doseresponse.default_vram_ladder(64.0, n_levels=9) == \
        ref_doseresponse.default_vram_ladder(64.0, n_levels=9)


def test_power_reader_samples_equal_reference():
    got = telemetry.SimulatedPowerReader(A100, seed=4,
                                         thermal_drift_w_per_hr=1.5)
    want = ref_telemetry.SimulatedPowerReader(RefA100, seed=4,
                                              thermal_drift_w_per_hr=1.5)
    for ctx, vram in ((False, 0.0), (True, 10.0), (True, 70.0)):
        got.set_state(context_active=ctx, vram_gb=vram)
        want.set_state(context_active=ctx, vram_gb=vram)
        for t in (0.0, 30.0, 3600.0):
            assert _fields(got.sample(t)) == _fields(want.sample(t))
    with pytest.raises(ValueError):
        got.set_state(context_active=True, vram_gb=100.0)


def test_phase1_fleet_analysis_equals_reference():
    ds = telemetry.simulate_fleet(seed=7)
    ref_ds = ref_telemetry.simulate_fleet(seed=7)
    assert len(ds) == len(ref_ds) == 336_226
    for f in dataclasses.fields(ds):
        assert np.array_equal(getattr(ds, f.name), getattr(ref_ds, f.name))
    split = phase1.split_states(ds)
    ref_split = ref_phase1.split_states(ref_ds)
    for k in ("bare", "ctx", "active_mask"):
        assert np.array_equal(split[k], ref_split[k])
    got = phase1.analyze_fleet(ds)
    want = ref_phase1.analyze_fleet(ref_ds)
    assert _fields(got) == _fields(want)
    assert 60 < got.context_effect_w < 85               # paper: 70.9


# ---------------------------------------------------------------------------
# simulator (Table 6): tests/test_scheduler_sim.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_simulate_equals_reference(pattern, policy):
    _, make, make_ref = policy
    arr = traffic.PATTERNS[pattern](seed=7)
    ref_arr = ref_traffic.PATTERNS[pattern](seed=7)
    assert np.array_equal(arr, ref_arr)
    got = simulate(arr, make(), H100, PYTORCH_70B)
    want = ref_simulator.simulate(ref_arr, make_ref(), RefH100,
                                  RefPYTORCH_70B)
    assert _fields(got) == _fields(want)
    served = simulate(arr, make(), H100, PYTORCH_70B, service_s=2.0,
                      start_warm=False)
    assert _fields(served) == _fields(ref_simulator.simulate(
        ref_arr, make_ref(), RefH100, RefPYTORCH_70B, service_s=2.0,
        start_warm=False))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_policies_equals_reference(seed):
    for gen, ref_gen in ((lambda s: traffic.poisson(5.0, seed=s),
                          lambda s: ref_traffic.poisson(5.0, seed=s)),
                         (lambda s: traffic.bursty(seed=s),
                          lambda s: ref_traffic.bursty(seed=s)),
                         (lambda s: traffic.diurnal(seed=s),
                          lambda s: ref_traffic.diurnal(seed=s))):
        arr, ref_arr = gen(seed), ref_gen(seed)
        got = compare_policies(
            arr, [scheduler.AlwaysOn(), scheduler.FixedTTL(300),
                  scheduler.Breakeven(PYTORCH_70B, H100),
                  scheduler.AdaptiveBreakeven(PYTORCH_70B, H100),
                  scheduler.Clairvoyant(PYTORCH_70B, H100)],
            H100, PYTORCH_70B)
        want = ref_simulator.compare_policies(
            ref_arr, [ref_scheduler.AlwaysOn(), ref_scheduler.FixedTTL(300),
                      ref_scheduler.Breakeven(RefPYTORCH_70B, RefH100),
                      ref_scheduler.AdaptiveBreakeven(RefPYTORCH_70B,
                                                      RefH100),
                      ref_scheduler.Clairvoyant(RefPYTORCH_70B, RefH100)],
            RefH100, RefPYTORCH_70B)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert got[-1].energy_wh <= min(r.energy_wh for r in got) + 1e-6


# ---------------------------------------------------------------------------
# the single-device anchor on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_single_device_fleet_engines_reproduce_simulator(pattern, policy):
    _, make, _ = policy
    arr = traffic.PATTERNS[pattern](seed=7)
    sim = simulate(arr, make(), H100, PYTORCH_70B)
    for res in (run_fleet(single_device_scenario(arr, make, PYTORCH_70B,
                                                 "h100")),
                run_mega(single_device_scenario(arr, make, PYTORCH_70B,
                                                "h100"),
                         backend="torch", device="cpu")):
        assert res.energy_wh == pytest.approx(sim.energy_wh, abs=1e-6)
        assert res.cold_starts == sim.cold_starts
        assert res.requests == sim.n_requests
        assert res.added_latency_s_total == \
            pytest.approx(sim.added_latency_s_total, abs=1e-6)


def test_always_on_h100_day_is_2920_8_wh():
    arr = traffic.poisson(5.0, seed=0)
    sim = simulate(arr, scheduler.AlwaysOn(), H100, PYTORCH_70B)
    assert sim.energy_wh == pytest.approx(121.7 * 24.0, rel=1e-9)
    assert sim.energy_wh == pytest.approx(2920.8, rel=1e-9)
    assert sim.cold_starts == 1
    res = run_mega(single_device_scenario(arr, scheduler.AlwaysOn,
                                          PYTORCH_70B, "h100"),
                   backend="torch", device="cpu")
    assert res.energy_wh == pytest.approx(2920.8, abs=1e-6)
