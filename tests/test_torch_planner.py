"""The port's Pareto planner (``repro_torch.fleet.planner``) against the
JAX package's.

The reference's ``plan_fleet`` defaults to its jax backend, which does
not import under JAX 0.9, so the port is held against the reference's
``backend="numpy"``: the port's numpy planner equal field for field,
and its torch planner (the plain PyTorch versions here,
``device="cpu"``) with every field equal but the engine label and
carbon, carbon and the hypervolume within 1e-9 relative (the carbon
lane's tolerance, ``tests/test_torch_mega.py``).  Batched equals
serial on the torch backend as ``tests/test_plan_batched.py`` requires
of the reference, and the 24 h pinned day hits the reference's anchors
(``tests/test_pricing.py``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, st

from repro.fleet import planner as ref_planner
from repro_torch.fleet import (OBJECTIVES, PlanAxes, PlanPoint, dominates,
                               hypervolume, pareto_front, plan_fleet)
from repro_torch.fleet.planner import (SPOT_ALL_FLEET, SPOT_H100_FLEET,
                                       ZONES3_FLEET, pinned_day_axes,
                                       pinned_day_base)

from conftest import P99_BOUND_S, REL

H6 = 6 * 3600.0
FLEETS = (ZONES3_FLEET, SPOT_H100_FLEET, SPOT_ALL_FLEET)
ROUTERS = ("warm-first", "slo-aware")
TIERS = ("on_demand", "reserved")
RATES = (0.0, 2.0)

# every PlanPoint field but eval_s (informational wall-clock)
COMPARED = ("fleet", "router", "price_tier", "preemption_rate",
            "cost_usd", "energy_wh", "carbon_kg", "p99_s", "engine",
            "gpu_hours_usd", "energy_usd", "preemptions", "requests")
# ... and all of them but the engine label and carbon
EXACT = tuple(f for f in COMPARED if f not in ("engine", "carbon_kg"))


def _key(p, fields=COMPARED):
    return tuple(getattr(p, f) for f in fields)


def _rel(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


_BASE6 = {}


def _base6(port=True):
    """The 6 h pinned day of either package, built once per run."""
    if port not in _BASE6:
        mod = pinned_day_base if port else ref_planner.pinned_day_base
        _BASE6[port] = mod(horizon_s=H6)
    return _BASE6[port]


@pytest.fixture(scope="module")
def ref6():
    return ref_planner.plan_fleet(_base6(False),
                                  ref_planner.pinned_day_axes(),
                                  backend="numpy")


@pytest.fixture(scope="module")
def torch6():
    return plan_fleet(_base6(), pinned_day_axes(), backend="torch",
                      device="cpu")


def _as_ref(p):
    return ref_planner.PlanPoint(**dataclasses.asdict(p))


def _assert_identical(a, b):
    assert [_key(p) for p in a.points] == [_key(p) for p in b.points]
    assert [_key(p) for p in a.frontier] == [_key(p) for p in b.frontier]
    assert _key(a.reference) == _key(b.reference)
    assert a.hypervolume == b.hypervolume


def _engine_of(label):
    return "mega" if label.startswith("mega-") else label


def _assert_torch_matches(got, want):
    """The torch planner against a numpy planner's result."""
    assert len(got.points) == len(want.points)
    for g, w in zip(got.points + [got.reference],
                    want.points + [want.reference]):
        assert _key(g, EXACT) == _key(w, EXACT)
        assert _engine_of(g.engine) == _engine_of(w.engine)
        assert g.engine in ("mega-torch", "fleet")
        assert _rel(g.carbon_kg, w.carbon_kg)
    assert [p.label() for p in got.frontier] == \
        [p.label() for p in want.frontier]
    assert _rel(got.hypervolume, want.hypervolume)


# ---------------------------------------------------------------------------
# dominance, frontier, hypervolume
# ---------------------------------------------------------------------------

def _pt(i, obj):
    return PlanPoint(fleet=f"f{i}", router="warm-first",
                     price_tier="on_demand", preemption_rate=0.0,
                     cost_usd=obj[0], energy_wh=obj[1], carbon_kg=obj[2],
                     p99_s=obj[3])


HAND = [
    [(1.0, 2.0, 3.0, 4.0)],
    [(1.0, 2.0, 3.0, 4.0), (2.0, 1.0, 3.0, 4.0), (2.0, 2.0, 3.0, 4.0)],
    [(1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0), (0.5, 2.0, 1.0, 0.0)],
    [(3.0, 0.0, 0.0, 0.0), (0.0, 3.0, 0.0, 0.0), (0.0, 0.0, 3.0, 0.0),
     (0.0, 0.0, 0.0, 3.0), (1.0, 1.0, 1.0, 1.0), (4.0, 4.0, 4.0, 4.0)],
]


@pytest.mark.parametrize("objs", HAND, ids=lambda o: f"{len(o)}-points")
def test_frontier_and_hypervolume_equal_reference_by_hand(objs):
    pts = [_pt(i, o) for i, o in enumerate(objs)]
    for a in objs:
        for b in objs:
            assert dominates(a, b) == ref_planner.dominates(a, b)
    front = pareto_front(pts)
    ref_front = ref_planner.pareto_front([_as_ref(p) for p in pts])
    assert [dataclasses.asdict(p) for p in front] == \
        [dataclasses.asdict(p) for p in ref_front]
    for reference in ((4.0, 4.0, 4.0, 4.0), (2.0, 2.0, 2.0, 0.0),
                      (1.0, 3.0, 5.0, 7.0)):
        assert hypervolume(front, reference) == \
            ref_planner.hypervolume(ref_front, reference)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 24),
       ties=st.booleans())
def test_frontier_and_hypervolume_equal_reference_random(seed, n, ties):
    rng = np.random.default_rng(seed)
    obj = rng.uniform(0.0, 2.0, size=(n, 4))
    if ties:                       # coarse values: duplicates and ties
        obj = np.round(obj * 2.0) / 2.0
    pts = [_pt(i, tuple(float(x) for x in o)) for i, o in enumerate(obj)]
    front = pareto_front(pts)
    ref_front = ref_planner.pareto_front([_as_ref(p) for p in pts])
    assert [dataclasses.asdict(p) for p in front] == \
        [dataclasses.asdict(p) for p in ref_front]
    reference = tuple(float(x) for x in rng.uniform(0.5, 2.0, size=4))
    hv = hypervolume(front, reference)
    assert hv == ref_planner.hypervolume(ref_front, reference)
    assert 0.0 <= hv <= 1.0
    for a in front:
        assert not any(dominates(b.objectives(), a.objectives())
                       for b in pts)


# ---------------------------------------------------------------------------
# plan_fleet against the reference's numpy planner (6 h pinned day)
# ---------------------------------------------------------------------------

def test_numpy_planner_equals_reference_field_for_field(ref6):
    got = plan_fleet(_base6(), pinned_day_axes(), backend="numpy")
    _assert_identical(got, ref6)
    assert got.stats["sims"] == ref6.stats["sims"]
    assert got.stats["points"] == ref6.stats["points"] == 20
    doc, ref_doc = json.loads(got.to_json()), json.loads(ref6.to_json())
    for d in (doc, ref_doc):
        for p in d["frontier"] + [d["reference"]]:
            p.pop("eval_s")
        d.pop("stats")
    assert doc == ref_doc
    for objective in OBJECTIVES:
        assert _key(got.best(objective)) == _key(ref6.best(objective))


def test_torch_planner_matches_reference(torch6, ref6):
    _assert_torch_matches(torch6, ref6)
    assert {p.engine for p in torch6.points} == {"mega-torch", "fleet"}
    for p in torch6.points:
        if p.preemption_rate > 0 or p.router != "warm-first":
            assert p.engine == "fleet", p.label()
        else:
            assert p.engine == "mega-torch", p.label()


def test_torch_planner_serial_matches_reference(ref6):
    got = plan_fleet(_base6(), pinned_day_axes(), backend="torch",
                     batched=False, device="cpu")
    _assert_torch_matches(got, ref6)
    assert got.stats["sims"] == got.stats["points"] == 20


def test_full_grid_batched_equals_serial_on_torch(torch6):
    serial = plan_fleet(_base6(), pinned_day_axes(), backend="torch",
                        batched=False, device="cpu")
    _assert_identical(serial, torch6)
    assert torch6.stats["sims"] < torch6.stats["points"]
    for a, b in zip(serial.points, torch6.points):
        assert (a.cost_usd, a.energy_wh, a.carbon_kg) == \
            (b.cost_usd, b.energy_wh, b.carbon_kg)


@settings(max_examples=4, deadline=None)
@given(nf=st.integers(min_value=1, max_value=3),
       nr=st.integers(min_value=1, max_value=2),
       nt=st.integers(min_value=1, max_value=2),
       with_faults=st.booleans(), reverse=st.booleans())
def test_random_subgrid_batched_equals_serial_on_torch(nf, nr, nt,
                                                       with_faults, reverse):
    fleets = FLEETS[:nf][::-1] if reverse else FLEETS[:nf]
    axes = PlanAxes(fleets=fleets, routers=ROUTERS[:nr],
                    price_tiers=TIERS[:nt],
                    preemption_rates=RATES if with_faults else (0.0,))
    serial = plan_fleet(_base6(), axes, backend="torch", batched=False,
                        device="cpu")
    batched = plan_fleet(_base6(), axes, backend="torch", batched=True,
                         device="cpu")
    _assert_identical(serial, batched)


def test_stats_shape():
    axes = PlanAxes(fleets=(ZONES3_FLEET,), routers=("warm-first",),
                    price_tiers=TIERS)
    res = plan_fleet(_base6(), axes, backend="torch", device="cpu")
    st_ = res.stats
    assert st_["mode"] == "batched"
    assert st_["points"] == 2 and st_["sims"] == 1
    assert st_["wall_s"] > 0.0
    # no CUDA library is built or loaded on the CPU
    assert isinstance(st_["compiles"], int) and st_["compiles"] == 0
    assert res.points[0].eval_s > 0.0
    assert res.points[1].eval_s == 0.0
    assert res.points[0].engine == res.points[1].engine == "mega-torch"


def test_backend_and_device_checks(monkeypatch):
    axes = PlanAxes(fleets=(ZONES3_FLEET,))
    with pytest.raises(ValueError, match="'torch' or 'numpy'"):
        plan_fleet(_base6(), axes, backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for batched in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            plan_fleet(_base6(), axes, batched=batched)


# ---------------------------------------------------------------------------
# the 24 h pinned day's anchors (tests/test_pricing.py::TestPlannerAcceptance)
# ---------------------------------------------------------------------------

def test_pinned_day_anchors_on_torch():
    sweep = plan_fleet(pinned_day_base(), pinned_day_axes(),
                       backend="torch", device="cpu")
    assert sweep.reference.cost_usd == pytest.approx(624.6396714072346,
                                                     rel=1e-6)
    best = sweep.best("cost_usd")
    assert best.cost_usd == pytest.approx(182.70635568021723, rel=1e-6)
    assert best.fleet == SPOT_ALL_FLEET
    assert best.preemption_rate > 0 and best.preemptions > 0
    assert best.p99_s <= P99_BOUND_S
    assert sweep.best("carbon_kg").carbon_kg == pytest.approx(
        2.7966818523969312, rel=1e-6)
    assert len(sweep.frontier) >= 3
    for p in sweep.points:
        assert p.requests == sweep.reference.requests
