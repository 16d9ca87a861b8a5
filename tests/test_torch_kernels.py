"""The port's metering kernels (plain PyTorch versions, which the CPU
path runs) against the JAX package: its jnp oracles (``kernels/ref``)
and its Pallas kernels in interpret mode, on the same numpy inputs.

Contract (the port's side of ``tests/test_kernels.py``'s fused-meter
and segment-trapz sweeps): ``e`` and ``s`` bit-identical to ``w*dt``
and ``dt``; ``c`` and ``fa`` within 1e-12 relative of the JAX side and
within 1e-9 of ``CarbonTrace.integral``.  The CUDA kernels themselves
need the card; ``chip_smoke.py`` holds them against these plain
versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.carbon import make_trace
from repro.kernels import ref as jref
from repro.kernels import segment_trapz as jpl
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_trapz as cuda_wrappers

SHAPES = ("solar-duck", "wind-night", "flat")


def _stacked(traces):
    """[G, K] knot tables, rows padded by repeating the last knot."""
    kmax = max(len(t._kt) for t in traces)

    def pad(rows):
        return np.stack([np.concatenate(
            [r, np.full(kmax - len(r), r[-1])]) for r in rows])

    return (pad([t._kt for t in traces]), pad([t._kv for t in traces]),
            pad([t._cum for t in traces]),
            np.array([t.period_s for t in traces]))


def _entries(n, seed, G):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0.0, 2.5 * 86400.0, n))
    b = a + rng.uniform(0.0, 4 * 3600.0, n)
    if n:
        b[n // 2] = a[n // 2]                       # a zero-width entry
    dt = b - a
    w = rng.uniform(10.0, 700.0, n)
    g = rng.integers(0, G, n).astype(np.int32)
    return a, b, dt, w, g


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax(fn, *xs, **kw):
    with jax.enable_x64(True):
        out = fn(*[jnp.asarray(x) for x in xs], **kw)
        return [np.asarray(o) for o in
                (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n", [0, 1, 33, 1024, 3001])
def test_fused_meter_matches_jax(n, seed, G):
    traces = [make_trace(s, 0.39) for s in SHAPES[:G]]
    tabs = _stacked(traces)
    a, b, dt, w, g = _entries(n, seed, G)
    got = [o.numpy() for o in
           ops.fused_meter(*map(_t, (a, b, dt, w, g) + tabs))]
    want_ref = _jax(jref.fused_meter_ref, a, b, dt, w, g, *tabs)
    want_pl = _jax(jpl.fused_meter, a, b, dt, w, g, *tabs, interpret=True)
    assert all(o.shape == (n,) and o.dtype == np.float64 for o in got)
    e, s, c, fa = got
    assert np.array_equal(e, w * dt)                # bit-identical
    assert np.array_equal(s, dt)
    for want in (want_ref, want_pl):
        assert np.array_equal(e, want[0]) and np.array_equal(s, want[1])
        np.testing.assert_allclose(c, want[2], rtol=1e-12, atol=0)
        np.testing.assert_allclose(fa, want[3], rtol=1e-12, atol=0)
    want_c = [traces[gi].integral(x, y) * z for gi, x, y, z in zip(g, a, b, w)]
    want_fa = [traces[gi].integral(0.0, x) for gi, x in zip(g, a)]
    np.testing.assert_allclose(c, np.array(want_c).reshape(n), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(fa, np.array(want_fa).reshape(n), rtol=1e-9,
                               atol=1e-12)
    if n:
        assert c[n // 2] == 0.0 and e[n // 2] == 0.0 and s[n // 2] == 0.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 17, 512, 2001])
def test_segment_trapz_matches_jax(n, shape):
    trace = make_trace(shape, 0.39)
    kt, kv, cum = (np.asarray(x, dtype=np.float64)
                   for x in (trace._kt, trace._kv, trace._cum))
    rng = np.random.default_rng(n)
    a = np.sort(rng.uniform(0.0, 3.0 * trace.period_s, n))
    b = a + rng.uniform(0.0, 5 * 3600.0, n)
    b[0] = a[0]                                     # a zero-width segment
    w = rng.uniform(10.0, 700.0, n)
    got = ops.segment_trapz(*map(_t, (a, b, w, kt, kv, cum)),
                            period=trace.period_s).numpy()
    for fn, kw in ((jref.segment_trapz_ref, {}),
                   (jpl.segment_trapz, {"interpret": True})):
        (want,) = _jax(fn, a, b, w, kt, kv, cum, period=trace.period_s, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    want = [trace.integral(x, y) * z for x, y, z in zip(a, b, w)]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert got[0] == 0.0


def test_segment_trapz_empty():
    trace = make_trace("solar-duck", 0.39)
    tabs = [_t(np.asarray(x, dtype=np.float64))
            for x in (trace._kt, trace._kv, trace._cum)]
    z = torch.zeros(0, dtype=torch.float64)
    assert ops.segment_trapz(z, z, z, *tabs,
                             period=trace.period_s).shape == (0,)


def test_fused_carbon_lane_matches_segment_trapz():
    """At G=1 the fused kernel's carbon lane is the standalone
    segment_trapz (same closed form, stacked vs scalar tables)."""
    trace = make_trace("wind-night", 0.39)
    tabs = _stacked([trace])
    rng = np.random.default_rng(3)
    n = 777
    a = np.sort(rng.uniform(0.0, 2.0 * trace.period_s, n))
    b = a + rng.uniform(0.0, 7200.0, n)
    w = rng.uniform(50.0, 400.0, n)
    _, _, c, _ = ops.fused_meter(*map(_t, (a, b, b - a, w,
                                           np.zeros(n, np.int32)) + tabs))
    flat = ops.segment_trapz(*map(_t, (a, b, w, tabs[0][0], tabs[1][0],
                                       tabs[2][0])), period=trace.period_s)
    np.testing.assert_allclose(c.numpy(), flat.numpy(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("n,num", [(0, 4), (1, 1), (500, 7), (4000, 60)])
def test_ordered_segment_sum_is_sequential(n, num):
    """Each key's entries are added left to right from 0.0 -- the exact
    rounding of a Python running sum, which the energy buckets need."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, num, n)
    vals = rng.uniform(0.0, 1e4, (2, n)) * rng.uniform(0.0, 1.0, (2, n))
    want = [[0.0] * num for _ in range(2)]
    for c in range(2):
        for k, v in zip(keys.tolist(), vals[c].tolist()):
            want[c][k] += v
    got = ops.ordered_segment_sum(_t(vals), _t(keys), num)
    assert got.dtype == torch.float64 and got.shape == (2, num)
    assert got.tolist() == want


def test_cpu_tensors_never_launch():
    """The CPU path runs the plain versions and counts no launch; the
    CUDA wrappers refuse a CPU tensor instead of computing on it."""
    ops.reset_launches()
    a, b, dt, w, g = _entries(33, 0, 1)
    tabs = _stacked([make_trace("solar-duck", 0.39)])
    ops.fused_meter(*map(_t, (a, b, dt, w, g) + tabs))
    ops.segment_trapz(*map(_t, (a, b, w, tabs[0][0], tabs[1][0],
                                tabs[2][0])), period=86400.0)
    ops.ordered_segment_sum(_t(np.stack([w, dt])),
                            _t(g.astype(np.int64)), 1)
    assert ops.launch_counts() == {"fused_meter": 0, "segment_trapz": 0,
                                   "ordered_segment_sum": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0,
                                   "rglru_scan": 0}
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_wrappers.fused_meter(*map(_t, (a, b, dt, w, g) + tabs))
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_wrappers.segment_trapz(*map(_t, (a, b, w) + tuple(
            x[0] for x in tabs[:3])), period=86400.0)
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_wrappers.ordered_segment_sum(_t(np.stack([w, dt])),
                                          _t(g.astype(np.int64)), 1)


def test_prefix_integral_matches_carbon_trace():
    """The shared closed form F(t), on one table and on row tables."""
    traces = [make_trace(s, 0.39) for s in SHAPES]
    kt, kv, cum, per = map(_t, _stacked(traces))
    t = np.linspace(0.0, 2.2 * 86400.0, 97)
    rows = ref.prefix_integral(_t(t)[None, :].expand(3, -1).contiguous(),
                               kt, kv, cum, per[:, None]).numpy()
    for gi, tr in enumerate(traces):
        want = [tr.integral(0.0, x) for x in t]
        np.testing.assert_allclose(rows[gi], want, rtol=1e-9, atol=1e-12)
        one = ref.prefix_integral(_t(t), *(_t(np.asarray(x)) for x in (
            tr._kt, tr._kv, tr._cum)), tr.period_s).numpy()
        np.testing.assert_allclose(one, rows[gi], rtol=1e-12, atol=0)
