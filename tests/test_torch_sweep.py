"""The port's mega sweep (``torchback.sweep_traces`` / ``run_mega_sweep``).

The reference samples its sweep days with jax.random, whose streams
PyTorch cannot reproduce, so the port is held by what the reference's
sampling guarantees rather than by its numbers: the same seeds give a
bit-identical batch, a point's day does not depend on the rest of the
batch, the route plan (child seeds, checkpoint sizes) is the numpy
generators' own, every rate family equals the numpy generator's rate
function to 1e-12 relative, and each route's count lies within 6 sigma
of the integral of its rate.  Then each sweep point replays on the
torch backend (the plain PyTorch versions here, ``device="cpu"``) as on
the numpy backend, under the gate of ``tests/test_torch_mega.py``; and
the reference's ``TestMegaSweep`` cases (``tests/test_mega.py``) hold
for the port.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, st

from repro.fleet.mega import traces as ref_traces
from repro_torch.core.scheduler import Breakeven
from repro_torch.fleet import (GENERATORS, MegaUnsupportedError, flash_crowd,
                               make_trace, run_mega, run_mega_sweep)
from repro_torch.fleet.mega import sweep_traces, torchback

from conftest import REL

H6 = 6 * 3600.0
DAY = 24 * 3600.0
SMALL = dict(n_routes=3, fleet="h100+l40s", base_rate_hr=8.0, horizon_s=H6,
             device="cpu")
# a day with the spike, the launch and the outage inside it
WIDE = dict(n_routes=4, fleet="h100+a100+l40s", base_rate_hr=20.0,
            horizon_s=DAY, spike_x=12.0, spike_width_s=2400.0, device="cpu")


def _arrays(trs):
    return [[r.arrivals_s for r in tr.routes] for tr in trs]


def _same_batch(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert (ta.name, ta.fleet, ta.horizon_s, ta.seed) == \
            (tb.name, tb.fleet, tb.horizon_s, tb.seed)
        assert [(r.route_id, r.checkpoint_gb) for r in ta.routes] == \
            [(r.route_id, r.checkpoint_gb) for r in tb.routes]
        for ra, rb in zip(ta.routes, tb.routes):
            assert ra.arrivals_s.dtype == np.float64
            assert np.array_equal(ra.arrivals_s, rb.arrivals_s)


def _rel(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def _assert_backends_match(got, want):
    """The torch backend against the numpy backend on one day."""
    assert got.requests == want.requests
    assert got.cold_starts == want.cold_starts
    assert got.energy_wh == want.energy_wh
    for gd, wd in zip(got.devices, want.devices):
        assert gd.energy_wh == wd.energy_wh
        assert gd.durations_s == wd.durations_s
        assert _rel(gd.carbon_kg, wd.carbon_kg)
    assert got.cost_usd == want.cost_usd
    assert np.array_equal(got.latencies_s, want.latencies_s)
    assert _rel(got.carbon_kg, want.carbon_kg)
    for (tg, cg), (tw, cw) in zip(got.carbon_timeline, want.carbon_timeline):
        assert tg == tw and _rel(cg, cw)


def _ref_rates(generator, n_routes, monkeypatch, **kw):
    """The numpy generator's own (rate, rmax) per route, captured from
    the reference's ``traces._thinned``."""
    seen = []

    def capture(rng, rate_hr, rate_max_hr, horizon_s):
        seen.append((rate_hr, rate_max_hr))
        return np.empty(0, dtype=np.float64)

    monkeypatch.setattr(ref_traces, "_thinned", capture)
    ref_traces.GENERATORS[generator](n_routes=n_routes, **kw)
    assert len(seen) == n_routes
    return seen


def _port_rates(generator, n_routes, **kw):
    """The port's rate family of each route."""
    kw = {"base_rate_hr": 40.0, "spike_x": 40.0,
          "spike_start_s": 13 * 3600.0, "spike_width_s": 1800.0, **kw}
    per_route = [None] * n_routes
    for routes, fn, rmax in torchback.sweep_rates(generator, n_routes, **kw):
        for i in routes:
            per_route[i] = (fn, rmax)
    assert None not in per_route
    return per_route


def _expected_count(rate_fn, horizon_s):
    """Integral of the rate (per hour) over the day, in arrivals."""
    t = np.linspace(0.0, horizon_s, int(horizon_s) * 2 + 1)
    r = rate_fn(torch.from_numpy(t)).numpy()
    return float(np.sum(0.5 * (r[1:] + r[:-1]) * np.diff(t))) / 3600.0


# ---------------------------------------------------------------------------
# the reference's TestMegaSweep, rewritten for the port
# ---------------------------------------------------------------------------

def test_seeds_sweep_runs_and_is_deterministic():
    kw = dict(SMALL)
    r1 = run_mega_sweep(seeds=[1, 2, 3], **kw)
    r2 = run_mega_sweep(seeds=[1, 2, 3], **kw)
    assert len(r1) == 3
    assert [a.energy_wh for a in r1] == [b.energy_wh for b in r2]
    assert [a.requests for a in r1] == [b.requests for b in r2]
    assert all(a.phase_timings is not None for a in r1)
    # distinct seeds, distinct days (on the CPU stream the three days'
    # totals happen to coincide at 21 requests, their routes do not)
    days = sweep_traces([1, 2, 3], **kw)
    assert len({tuple(r.arrivals_s.size for r in tr.routes)
                for tr in days}) == 3
    assert [tr.requests for tr in days] == [a.requests for a in r1]
    assert len({a.energy_wh for a in r1}) > 1


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_sweep_traces_generator_shapes(gen):
    trs = sweep_traces([5], generator=gen, n_routes=3, horizon_s=H6,
                       device="cpu")
    assert len(trs) == 1 and len(trs[0].routes) == 3
    assert trs[0].requests > 0
    assert trs[0].name == f"{gen}-sweep"
    for r in trs[0].routes:
        assert np.all(np.diff(r.arrivals_s) >= 0.0)
        assert np.all((r.arrivals_s >= 0.0) & (r.arrivals_s < H6))


def test_unknown_generator_raises():
    with pytest.raises(KeyError, match="unknown sweep generator"):
        sweep_traces([5], generator="meteor-strike", device="cpu")
    with pytest.raises(KeyError, match="unknown sweep generator"):
        run_mega_sweep(seeds=[5], generator="meteor-strike", device="cpu")


def test_scenarios_sweep_matches_run_mega():
    tr = flash_crowd(n_routes=3, fleet="h100+l40s", seed=9, horizon_s=H6)
    ref = run_mega(tr.to_scenario(Breakeven), backend="torch",
                   device="cpu", compute_bound=False)
    got = run_mega_sweep(scenarios=[tr.to_scenario(Breakeven)],
                         device="cpu")[0]
    assert got.energy_wh == ref.energy_wh
    assert got.requests == ref.requests
    assert got.cold_starts == ref.cold_starts


def test_argument_validation():
    with pytest.raises(ValueError, match="exactly one"):
        run_mega_sweep()
    with pytest.raises(ValueError, match="exactly one"):
        run_mega_sweep(scenarios=[], seeds=[1])
    with pytest.raises(ValueError, match="need seeds"):
        run_mega_sweep(scenarios=[], n_routes=4)
    with pytest.raises(ValueError, match="on_unsupported"):
        run_mega_sweep(scenarios=[], on_unsupported="ignore")


def test_on_unsupported_skip_returns_none_slots():
    tr = flash_crowd(n_routes=3, fleet="h100+l40s", seed=9, horizon_s=H6)
    good = tr.to_scenario(Breakeven)
    bad = dataclasses.replace(tr.to_scenario(Breakeven), router="slo-aware")
    out = run_mega_sweep(scenarios=[good, bad], on_unsupported="skip",
                         device="cpu")
    assert out[0] is not None and out[0].requests > 0
    assert out[1] is None
    with pytest.raises(MegaUnsupportedError):
        run_mega_sweep(scenarios=[tr.to_scenario(Breakeven), bad],
                       device="cpu")
    with pytest.raises(ValueError, match="on_unsupported"):
        run_mega_sweep(scenarios=[good], on_unsupported="ignore",
                       device="cpu")


# ---------------------------------------------------------------------------
# the sampling's own contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_same_seeds_give_a_bit_identical_batch(gen):
    a = sweep_traces([3, 1, 4], generator=gen, **WIDE)
    b = sweep_traces([3, 1, 4], generator=gen, **WIDE)
    _same_batch(a, b)
    c = sweep_traces([3, 1, 5], generator=gen, **WIDE)
    assert not all(np.array_equal(x, y) for x, y in
                   zip(_arrays(a)[2], _arrays(c)[2]))


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_a_points_day_does_not_depend_on_the_batch(gen):
    batch = sweep_traces([11, 5, 7, 2], generator=gen, **WIDE)
    for p, seed in enumerate([11, 5, 7, 2]):
        _same_batch(sweep_traces([seed], generator=gen, **WIDE), [batch[p]])
    _same_batch(sweep_traces([2, 5], generator=gen, **WIDE),
                [batch[3], batch[1]])


def test_batch_independence_check_sees_position_seeded_routes(monkeypatch):
    """The planted fault of chip_smoke's sweep phase: route seeds taken
    from the batch position (as one generator for the whole batch
    would) must fail the batch-independence comparison."""
    real = torchback._sample_group
    monkeypatch.setattr(torchback, "_sample_group", lambda child, *a: real(
        [child[0] + r for r in range(len(child))], *a))
    batch = sweep_traces([11, 5, 7], **SMALL)
    with pytest.raises(AssertionError):
        _same_batch(sweep_traces([5], **SMALL), [batch[1]])


@settings(max_examples=6, deadline=None)
@given(seeds=st.lists(st.integers(0, 2 ** 31 - 2), min_size=1, max_size=4),
       pick=st.integers(0, 3))
def test_batch_independence_property(seeds, pick):
    kw = dict(SMALL, n_routes=2)
    seed = seeds[pick % len(seeds)]
    batch = sweep_traces(seeds, **kw)
    _same_batch(sweep_traces([seed], **kw), [batch[pick % len(seeds)]])


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_route_plan_is_the_numpy_generators(gen):
    n_routes = 5
    trs = sweep_traces([0, 100, 12345], generator=gen, n_routes=n_routes,
                       fleet="2xh100+a100", horizon_s=H6, device="cpu")
    for seed, tr in zip([0, 100, 12345], trs):
        _, ckpt = ref_traces._route_plan(np.random.default_rng(seed),
                                         n_routes)
        numpy_day = ref_traces.GENERATORS[gen](
            n_routes=n_routes, fleet="2xh100+a100", horizon_s=H6, seed=seed)
        assert tr.name == f"{gen}-sweep"
        assert tr.fleet == numpy_day.fleet == "2xh100+a100"
        assert tr.seed == seed and tr.horizon_s == H6
        assert [r.route_id for r in tr.routes] == \
            [r.route_id for r in numpy_day.routes]
        assert [r.checkpoint_gb for r in tr.routes] == \
            [float(c) for c in ckpt] == \
            [r.checkpoint_gb for r in numpy_day.routes]


@pytest.mark.parametrize("gen,kw", [
    ("flash-crowd", {}),
    ("flash-crowd", dict(base_rate_hr=130.0, spike_x=60.0)),
    ("flash-crowd", dict(base_rate_hr=7.5, spike_x=3.0,
                         spike_start_s=2 * 3600.0, spike_width_s=977.0)),
    ("product-launch", {}),
    ("product-launch", dict(base_rate_hr=30.0)),
    ("regional-outage", dict(base_rate_hr=40.0)),
    ("regional-outage", dict(base_rate_hr=13.0)),
], ids=lambda v: v if isinstance(v, str) else
    ",".join(f"{k}={x:g}" for k, x in v.items()) or "defaults")
def test_rate_families_equal_numpy_generators(gen, kw, monkeypatch):
    n_routes = 3
    ref_kw = dict(kw)
    if gen == "regional-outage":
        ref_kw.setdefault("base_rate_hr", 40.0)
    if gen != "flash-crowd":
        for k in ("spike_x", "spike_start_s", "spike_width_s"):
            ref_kw.pop(k, None)
    want = _ref_rates(gen, n_routes, monkeypatch, **ref_kw)
    got = _port_rates(gen, n_routes, **kw)
    edges = [0.0, 9 * 3600.0, 11 * 3600.0, 12 * 3600.0, 12.5 * 3600.0,
             kw.get("spike_start_s", 13 * 3600.0)]
    w = kw.get("spike_width_s", 1800.0)
    edges += [edges[-1] + w, edges[-1] + 3 * w]
    t = np.concatenate([np.linspace(0.0, 30 * 3600.0, 400_001),
                        np.array(edges), np.nextafter(edges, -np.inf),
                        np.nextafter(edges, np.inf)])
    for (fn, rmax), (ref_fn, ref_rmax) in zip(got, want):
        assert rmax == ref_rmax
        r = fn(torch.from_numpy(t)).numpy()
        ref_r = ref_fn(t)
        assert r.dtype == np.float64
        assert np.array_equal(r == 0.0, ref_r == 0.0)
        assert np.allclose(r, ref_r, rtol=1e-12, atol=0.0)
        assert np.all(r <= rmax * (1 + 1e-12))


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_route_counts_within_poisson_bounds(gen):
    seeds = list(range(12))
    trs = sweep_traces(seeds, generator=gen, **WIDE)
    rates = _port_rates(gen, WIDE["n_routes"], base_rate_hr=20.0,
                        spike_x=12.0, spike_width_s=2400.0)
    for tr in trs:
        for i, r in enumerate(tr.routes):
            mu = _expected_count(rates[i][0], DAY)
            assert abs(r.arrivals_s.size - mu) <= 6.0 * math.sqrt(mu), \
                (tr.seed, i, r.arrivals_s.size, mu)


def test_envelope_count_is_clamped(monkeypatch):
    monkeypatch.setattr(torchback, "_envelope_n", lambda rmax, h: 7)
    trs = sweep_traces([1, 2], generator="regional-outage", **WIDE)
    for tr in trs:
        assert all(r.arrivals_s.size <= 7 for r in tr.routes)
        assert all(np.all(np.isfinite(r.arrivals_s)) for r in tr.routes)


def test_samples_on_the_device_it_is_given(monkeypatch):
    seen = []
    real = torch.poisson

    def poisson(lam, generator=None):
        seen.append((lam.device.type, generator.device.type))
        return real(lam, generator=generator)

    monkeypatch.setattr(torch, "poisson", poisson)
    sweep_traces([1, 2], **SMALL)
    assert seen == [("cpu", "cpu")] * 6


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in SMALL.items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_traces([1], **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mega_sweep(seeds=[1], **kw)
    tr = flash_crowd(n_routes=3, fleet="h100+l40s", seed=9, horizon_s=H6)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mega_sweep(scenarios=[tr.to_scenario(Breakeven)])


def test_compiled_program_count_is_zero_on_the_cpu():
    n = torchback.compiled_program_count()
    assert isinstance(n, int)
    run_mega_sweep(seeds=[1], **SMALL)
    assert torchback.compiled_program_count() == n == 0


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_each_point_replays_on_torch_as_on_numpy(gen):
    kw = dict(WIDE, n_routes=3, fleet="2xh100+a100+l40s")
    ct = make_trace("solar-duck", 0.39)
    got = run_mega_sweep(seeds=[21, 22], generator=gen,
                         scenario_kw={"carbon_trace": ct}, **kw)
    for tr, res in zip(sweep_traces([21, 22], generator=gen, **kw), got):
        want = run_mega(tr.to_scenario(Breakeven, carbon_trace=ct),
                        backend="numpy", compute_bound=False)
        _assert_backends_match(res, want)
        assert res.requests == tr.requests
