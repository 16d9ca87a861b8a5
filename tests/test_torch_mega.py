"""The port's mega simulator against the JAX package's numpy reference.

``repro_torch.fleet.run_mega`` with ``backend="torch"`` (on the CPU
here: the plain PyTorch versions of the kernels), fused and unfused,
and with ``backend="numpy"``, against ``repro.fleet.run_mega(backend=
"numpy")`` on the same days.  Days made by the reference cross into
the port as plain fields and numpy arrays (``repro_torch.convert``).

Contract: requests and cold starts equal; per-(device, state) energy
and seconds bit-equal (the in-order segment sums), hence energy and
every dollar figure equal; carbon, the hourly timeline and per-tier
billed seconds within 1e-9 relative; the port's numpy backend and
``run_fleet`` bit-equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.scheduler import Breakeven as RefBreakeven
from repro.fleet import flash_crowd as ref_flash_crowd
from repro.fleet import make_trace as ref_make_trace
from repro.fleet import mixed_fleet_scenario as ref_mixed
from repro.fleet import run_fleet as ref_run_fleet
from repro.fleet import run_mega as ref_run_mega
from repro_torch.convert import carbon_trace_from_numpy, fleet_trace_from_numpy
from repro_torch.core.scheduler import Breakeven
from repro_torch.fleet import (FleetTrace, mixed_fleet_scenario, run_fleet,
                               run_mega)
from repro_torch.fleet.mega import torchback

from conftest import PIN_SEED, REL, ZONES3

H2 = 2 * 3600.0


def _port_trace(tr):
    return fleet_trace_from_numpy(
        tr.name, tr.fleet, tr.horizon_s,
        [(r.route_id, r.arrivals_s, r.checkpoint_gb, r.zone)
         for r in tr.routes], tr.seed)


def _port_carbon(ct):
    return carbon_trace_from_numpy(ct.name, ct.points, ct.period_s)


def _flash_ref():
    return ref_flash_crowd(n_routes=3, fleet="1xh100+1xl40s", seed=PIN_SEED,
                           horizon_s=H2, base_rate_hr=6.0)


# each day: (reference scenario factory, port scenario factory)
DAYS = {
    "pinned": (lambda: ref_mixed(RefBreakeven, "warm-first", seed=PIN_SEED),
               lambda: mixed_fleet_scenario(Breakeven, "warm-first",
                                            seed=PIN_SEED)),
    "zones3": (lambda: ref_mixed(RefBreakeven, "warm-first", seed=PIN_SEED,
                                 fleet=ZONES3, carbon_trace="zone"),
               lambda: mixed_fleet_scenario(Breakeven, "warm-first",
                                            seed=PIN_SEED, fleet=ZONES3,
                                            carbon_trace="zone")),
    "flash3": (lambda: _flash_ref().to_scenario(
                   RefBreakeven,
                   carbon_trace=ref_make_trace("solar-duck", 0.39)),
               lambda: _port_trace(_flash_ref()).to_scenario(
                   Breakeven, carbon_trace=_port_carbon(
                       ref_make_trace("solar-duck", 0.39)))),
}


def _fields(res):
    """Every FleetResult field but the wall-clock phase timings."""
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name != "phase_timings"}


def _assert_bit_equal(got, want):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert np.array_equal(g[k], w[k]), k
        elif k == "devices":
            assert [_fields(d) for d in g[k]] == [_fields(d) for d in w[k]]
        else:
            assert g[k] == w[k], k


def _rel(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def _assert_torch_matches(got, want):
    assert got.requests == want.requests
    assert got.cold_starts == want.cold_starts
    # in-order segment sums: bit-equal energy buckets, hence equal money
    assert got.energy_wh == want.energy_wh
    for gd, wd in zip(got.devices, want.devices):
        assert gd.energy_wh == wd.energy_wh
        assert gd.durations_s == wd.durations_s
        assert _rel(gd.carbon_kg, wd.carbon_kg)
    assert got.state_energy_wh == want.state_energy_wh
    assert got.cost_usd == want.cost_usd
    assert got.gpu_hours_usd == want.gpu_hours_usd
    assert got.energy_usd == want.energy_usd
    assert got.added_latency_s_total == want.added_latency_s_total
    assert np.array_equal(got.latencies_s, want.latencies_s)
    assert got.power_timeline == want.power_timeline
    assert _rel(got.carbon_kg, want.carbon_kg)
    assert len(got.carbon_timeline) == len(want.carbon_timeline)
    for (tg, cg), (tw, cw) in zip(got.carbon_timeline, want.carbon_timeline):
        assert tg == tw and _rel(cg, cw)
    assert got.tier_billed_s.keys() == want.tier_billed_s.keys()
    for k, v in want.tier_billed_s.items():
        assert _rel(got.tier_billed_s[k], v)


@pytest.fixture(params=sorted(DAYS))
def day(request):
    ref_sc, port_sc = DAYS[request.param]
    return ref_run_mega(ref_sc(), backend="numpy"), port_sc


def test_port_numpy_backend_bit_equal_to_reference(day):
    want, port_sc = day
    _assert_bit_equal(run_mega(port_sc(), backend="numpy"), want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_torch_backend_matches_reference(day, fused, monkeypatch):
    want, port_sc = day
    monkeypatch.setattr(torchback, "FUSED", fused)
    got = run_mega(port_sc(), backend="torch", device="cpu")
    _assert_torch_matches(got, want)
    assert set(got.phase_timings) == set(want.phase_timings)


def test_fused_energy_equals_unfused(monkeypatch):
    runs = []
    for fused in (True, False):
        monkeypatch.setattr(torchback, "FUSED", fused)
        runs.append(run_mega(DAYS["zones3"][1](), device="cpu"))
    a, b = runs
    assert a.energy_wh == b.energy_wh
    assert [d.energy_wh for d in a.devices] == [d.energy_wh for d in b.devices]
    assert [d.durations_s for d in a.devices] == \
        [d.durations_s for d in b.devices]
    assert _rel(a.carbon_kg, b.carbon_kg)


def test_run_fleet_bit_equal_to_reference():
    want = ref_run_fleet(DAYS["pinned"][0]())
    got = run_fleet(DAYS["pinned"][1]())
    _assert_bit_equal(got, want)


def test_mini_day_round_trips_byte_identical(tmp_path):
    import pathlib
    src = pathlib.Path(__file__).parent / "data" / "mini_day.jsonl"
    tr = FleetTrace.from_jsonl(src)
    out = tmp_path / "again.jsonl"
    tr.to_jsonl(out)
    assert out.read_bytes() == src.read_bytes()


def test_reference_jsonl_replays_to_same_result(tmp_path):
    ref_tr = _flash_ref()
    path = tmp_path / "day.jsonl"
    ref_tr.to_jsonl(path)
    port_tr = FleetTrace.from_jsonl(path)
    assert port_tr.to_records() == _port_trace(ref_tr).to_records()
    trace = ref_make_trace("solar-duck", 0.39)
    want = ref_run_mega(ref_tr.to_scenario(RefBreakeven, carbon_trace=trace),
                        backend="numpy")
    got = run_mega(port_tr.to_scenario(Breakeven,
                                       carbon_trace=_port_carbon(trace)),
                   device="cpu")
    _assert_torch_matches(got, want)


def test_carbon_trace_conversion_is_exact():
    for shape in ("solar-duck", "wind-night", "flat"):
        ref_ct = ref_make_trace(shape, 0.39)
        ct = _port_carbon(ref_ct)
        assert (ct._kt, ct._kv, ct._cum) == (ref_ct._kt, ref_ct._kv,
                                             ref_ct._cum)
        assert ct.integral(1234.5, 200000.0) == \
            ref_ct.integral(1234.5, 200000.0)


def test_backend_seam_rejects_unknown_and_absent_cuda(monkeypatch):
    with pytest.raises(ValueError, match="'torch' or 'numpy'"):
        run_mega(DAYS["pinned"][1](), backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mega(DAYS["pinned"][1]())
