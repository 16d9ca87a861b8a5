#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds every kernel against its plain PyTorch version on
the card, then drives ``repro_torch.fleet.run_mega(backend="torch")``
on the 600-device, ~1M-request acceptance day and checks it against
the port's numpy backend.  Phases, in order:

  1. the card (``nvidia-smi`` name and power limit) and the build time;
  2. each kernel against its plain version at small and acceptance-day
     shapes (``e``/``s`` and the energy sums bit-equal, ``c``/``fa``
     within 1e-12 relative), with CUDA-event times (per call, median of
     7 rounds of back-to-back calls, L2 flushed before each round)
     beside the least time the card could take;
  3. the acceptance day on the fused lane (the main path), with the
     launch counters reset just before it and read just after;
  4. the unfused lane on a 24-route day, then the 3-zone pinned day
     (several carbon traces in one fused launch);
  5. one JSON line describing every kernel;
  6. as the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line.  It also exits non-zero without a CUDA device.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_METER = 790_603          # charge-log entries of the acceptance day
N_SEG = 790_002            # metered power segments of the acceptance day
N_DEV = 600
REL_KERNEL = 1e-12         # carbon lanes vs their plain versions
REL_DAY = 1e-9             # torch backend vs numpy backend totals
DEV = "cuda"

# NVIDIA H100 data sheet: memory bandwidth and FP64 (non-tensor) peak
# per form factor, matched against torch.cuda.get_device_name().
_PEAKS = (("PCIe", 2.0e12, 26e12), ("NVL", 3.9e12, 30e12),
          ("", 3.35e12, 34e12))


def _peaks(name):
    for key, bw, fp64 in _PEAKS:
        if key in name:
            return bw, fp64
    raise AssertionError("unreachable")


def _bound_ms(name, nbytes, flops):
    bw, fp64 = _peaks(name)
    t_bytes, t_ops = nbytes / bw, flops / fp64
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def _time_ms(fn, torch, reps=20, rounds=7):
    """Per-call CUDA-event time of ``fn``: events around ``reps``
    back-to-back calls, the L2 flushed before each round, median over
    ``rounds`` after a warm-up call."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEV)
    fn()
    times = []
    for _ in range(rounds):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _raw(cu, fn_name, torch, *args):
    """A call of one C entry point with preallocated outputs: times the
    kernel itself, without the wrapper's checks and allocations (and
    without touching the wrapper's launch count)."""
    fn = cu._fn(fn_name)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {rc}")

    return run


def _rel_close(x, y, rel):
    """|x - y| <= rel * |y| elementwise; returns the max abs error."""
    import torch
    err = (x - y).abs()
    if not bool(torch.all(err <= rel * y.abs())):
        bad = int(torch.argmax(err / y.abs().clamp_min(1e-300)))
        raise AssertionError(f"mismatch beyond {rel} rel at {bad}: "
                             f"{float(x[bad])!r} vs {float(y[bad])!r}")
    return float(err.max()) if err.numel() else 0.0


def build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"({', '.join(f'{k}.cu {v:.3f} s' for k, v in secs.items())})")
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _tables(traces, torch):
    import numpy as np
    kmax = max(len(t._kt) for t in traces)

    def pad(rows):
        return np.stack([np.concatenate([r, np.full(kmax - len(r), r[-1])])
                         for r in rows])

    tabs = (pad([t._kt for t in traces]), pad([t._kv for t in traces]),
            pad([t._cum for t in traces]),
            np.array([t.period_s for t in traces]))
    return [torch.from_numpy(x).to(DEV) for x in tabs]


def _entries(n, seed, G, torch):
    import numpy as np
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0.0, 1.2 * 86400.0, n))
    b = a + rng.exponential(110.0, n)
    if n:
        b[n // 2] = a[n // 2]                       # a zero-width entry
    w = rng.uniform(60.0, 700.0, n)
    g = rng.integers(0, G, n).astype(np.int32)
    return [torch.from_numpy(x).to(DEV) for x in (a, b, b - a, w, g)]


def check_kernels(quick=False):
    """Phase 2: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from repro_torch.fleet import make_trace
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_trapz as cu

    name = torch.cuda.get_device_name(0)
    shapes = ("solar-duck", "wind-night", "flat")
    stats = {}
    big_m = 0 if quick else N_METER
    for G in (1, 3):
        tabs = _tables([make_trace(s, 0.39) for s in shapes[:G]], torch)
        for n in (0, 1, 33, 3001, big_m):
            a, b, dt, w, g = _entries(n, n + G, G, torch)
            got = ops.fused_meter(a, b, dt, w, g, *tabs)
            want = ref.fused_meter_ref(a, b, dt, w, g, *tabs)
            torch.cuda.synchronize()
            assert all(o.device == a.device and o.shape == (n,)
                       for o in got)
            assert torch.equal(got[0], want[0]) and torch.equal(got[0],
                                                                w * dt)
            assert torch.equal(got[1], want[1]) and torch.equal(got[1], dt)
            err = max(_rel_close(got[2], want[2], REL_KERNEL),
                      _rel_close(got[3], want[3], REL_KERNEL))
            assert bool(torch.isfinite(got[2]).all())
            print(f"fused_meter   G={G} N={n:>7}: e,s bit-equal; "
                  f"c,fa max abs err {err:.3e}")
            if G == 1 and n == big_m:
                stats["fused_meter"] = {"max_abs_err": err, "n": n}
                args = (a, b, dt, w, g, *tabs)
    K = args[5].shape[1]
    big_s = 0 if quick else N_SEG
    tr = make_trace("solar-duck", 0.39)
    kt, kv, cum = (torch.tensor(x, dtype=torch.float64, device=DEV)
                   for x in (tr._kt, tr._kv, tr._cum))
    for n in (1, 17, 2001, big_s):
        a, b, _dt, w, _g = _entries(n, n, 1, torch)
        got = ops.segment_trapz(a, b, w, kt, kv, cum, period=tr.period_s)
        want = ref.segment_trapz_ref(a, b, w, kt, kv, cum,
                                     period=tr.period_s)
        torch.cuda.synchronize()
        err = _rel_close(got, want, REL_KERNEL)
        print(f"segment_trapz N={n:>7}: out max abs err {err:.3e}")
        if n == big_s:
            stats["segment_trapz"] = {"max_abs_err": err, "n": n}
            sargs = (a, b, w, kt, kv, cum)
    num = N_DEV * 3
    for n in (0, 1, 1000, big_m):
        rng = np.random.default_rng(n)
        keys = torch.from_numpy(rng.integers(0, num, n)).to(DEV)
        vals = torch.from_numpy(rng.uniform(0.0, 5e5, (2, n))).to(DEV)
        got = ops.ordered_segment_sum(vals, keys, num)
        want = ref.ordered_segment_sum_ref(vals, keys, num)
        torch.cuda.synchronize()
        assert torch.equal(got, want), "ordered_segment_sum not bit-equal"
        print(f"ordered_segment_sum N={n:>7}: bit-equal")
        if n == big_m:
            stats["ordered_segment_sum"] = {"max_abs_err": 0.0, "n": n}
            oargs = (vals, keys, num)
    if quick:
        return stats

    # times at the acceptance day's shapes, beside the least time
    def ptrs(*ts):
        return [t.data_ptr() for t in ts]

    G1 = 1
    t = stats["fused_meter"]
    outs = [torch.empty_like(args[0]) for _ in range(4)]
    t["ms"] = _time_ms(_raw(cu, "fused_meter_f64", torch,
                            *ptrs(*args, *outs), big_m, G1, K), torch)
    t["plain_ms"] = _time_ms(lambda: ref.fused_meter_ref(*args), torch,
                             reps=3)
    t["bound_ms"], t["bound_by"] = _bound_ms(
        name, big_m * (4 * 8 + 4) + big_m * 4 * 8 + (3 * G1 * K + G1) * 8,
        35 * big_m)      # two prefix integrals (~16 FP64 ops each) + e, c
    t["library_ms"] = None
    t = stats["segment_trapz"]
    out = torch.empty_like(sargs[0])
    t["ms"] = _time_ms(_raw(cu, "segment_trapz_f64", torch, *ptrs(*sargs),
                            float(tr.period_s), out.data_ptr(), big_s,
                            len(tr._kt)), torch)
    t["plain_ms"] = _time_ms(lambda: ref.segment_trapz_ref(
        *sargs, period=tr.period_s), torch, reps=3)
    t["bound_ms"], t["bound_by"] = _bound_ms(
        name, big_s * 4 * 8 + 3 * len(tr._kt) * 8, 34 * big_s)
    t["library_ms"] = None
    t = stats["ordered_segment_sum"]
    vals, keys, num = oargs
    # the whole function (stable sort + run offsets + the in-order walk)
    t["ms"] = _time_ms(lambda: cu.ordered_segment_sum(*oargs), torch)
    order = torch.sort(keys, stable=True).indices
    offsets = torch.zeros(num + 1, dtype=torch.int64, device=DEV)
    torch.cumsum(torch.bincount(keys, minlength=num), 0, out=offsets[1:])
    out = torch.empty(2, num, dtype=torch.float64, device=DEV)
    t["walk_ms"] = _time_ms(_raw(
        cu, "ordered_segment_sum_f64", torch,
        *ptrs(vals, order, offsets, out), keys.numel(), 2, num), torch)
    t["plain_ms"] = _time_ms(lambda: ref.ordered_segment_sum_ref(*oargs),
                             torch, reps=1, rounds=3)
    t["bound_ms"], t["bound_by"] = _bound_ms(
        name, vals.numel() * 8 + keys.numel() * 8 + 2 * num * 8,
        vals.numel())
    t["library_ms"] = _time_ms(
        lambda: torch.zeros(2, num, dtype=torch.float64, device=DEV)
        .index_add_(1, keys, vals), torch)
    print(f"time ordered_segment_sum in-order walk alone: "
          f"{t.pop('walk_ms'):.4f} ms")
    for k, v in stats.items():
        print(f"time {k:20s} N={v['n']}: kernel {v['ms']:.4f} ms, plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}), library "
              f"{'n/a' if v['library_ms'] is None else '%.4f ms' % v['library_ms']}")
    return stats


def _compare_days(got, want, label):
    """The torch backend against the numpy backend on one day."""
    assert got.requests == want.requests, (got.requests, want.requests)
    assert got.cold_starts == want.cold_starts
    for gd, wd in zip(got.devices, want.devices):
        assert gd.energy_wh == wd.energy_wh, gd.instance_id   # bit-equal
        assert gd.durations_s == wd.durations_s, gd.instance_id
    assert got.energy_wh == want.energy_wh
    assert got.cost_usd == want.cost_usd
    assert got.gpu_hours_usd == want.gpu_hours_usd
    assert got.energy_usd == want.energy_usd

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-300)

    worst = rel(got.carbon_kg, want.carbon_kg)
    assert len(got.carbon_timeline) == len(want.carbon_timeline)
    for (tg, cg), (tw, cw) in zip(got.carbon_timeline, want.carbon_timeline):
        assert tg == tw
        worst = max(worst, rel(cg, cw))
    for gd, wd in zip(got.devices, want.devices):
        worst = max(worst, rel(gd.carbon_kg, wd.carbon_kg))
    for k, v in want.tier_billed_s.items():
        worst = max(worst, rel(got.tier_billed_s[k], v))
    assert worst <= REL_DAY, f"{label}: carbon/tier drift {worst:.3e}"
    import math
    assert math.isfinite(got.carbon_kg) and got.energy_wh > 0
    print(f"{label}: {got.requests:,} requests, {got.cold_starts} cold "
          f"starts, {len(got.devices)} devices; energy/seconds per "
          f"(device, state) bit-equal, cost equal (${got.cost_usd!r}), "
          f"carbon/timeline/tier max rel diff {worst:.3e}")


def _drive(scenario_fn, label, **kw):
    """Numpy backend, then the torch backend on the card (launch counts
    reset just before the torch run and read just after)."""
    import torch

    from repro_torch.fleet import run_mega
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    want = run_mega(scenario_fn(), backend="numpy", **kw)
    t_np = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = run_mega(scenario_fn(), backend="torch", device=DEV, **kw)
    torch.cuda.synchronize()
    t_cu = time.perf_counter() - t0
    launches = ops.launch_counts()
    for tag, res, wall in (("numpy", want, t_np), ("torch/cuda", got, t_cu)):
        pt = {k: round(v, 6) for k, v in res.phase_timings.items()}
        print(f"{label} [{tag}] wall {wall:.3f} s; phase_timings {pt}")
    print(f"{label} launches {launches}")
    _compare_days(got, want, label)
    return launches


def drive_days():
    """Phases 3 and 4; returns the launch counts of each path."""
    from repro_torch.core.scheduler import Breakeven
    from repro_torch.fleet import flash_crowd, make_trace
    from repro_torch.fleet import mixed_fleet_scenario
    from repro_torch.fleet.mega import torchback
    from repro_torch.kernels import ops

    ct = make_trace("solar-duck", 0.39)
    shapes = {}
    real_fm = ops.fused_meter

    def seen_fused_meter(a, b, dt, w, g, kt, *rest):
        shapes["fused_meter"] = (a.shape[0], tuple(kt.shape))
        return real_fm(a, b, dt, w, g, kt, *rest)

    torchback.ops.fused_meter = seen_fused_meter    # records shapes only
    try:
        torchback.FUSED = True
        day = flash_crowd(n_routes=600, fleet="200xh100+200xa100+200xl40s",
                          seed=100, base_rate_hr=130.0, spike_x=60.0)
        main = _drive(lambda: day.to_scenario(Breakeven, carbon_trace=ct),
                      "acceptance day (fused)", compute_bound=False)
        print(f"acceptance day fused_meter N, [G, K] = "
              f"{shapes['fused_meter']}")
        assert main["fused_meter"] > 0 and main["ordered_segment_sum"] > 0
        torchback.FUSED = False
        d24 = flash_crowd(n_routes=24, fleet="2xh100+2xa100+2xl40s",
                          seed=100, horizon_s=6 * 3600.0, base_rate_hr=40.0)
        unfused = _drive(lambda: d24.to_scenario(Breakeven, carbon_trace=ct),
                         "24-route day (unfused)", compute_bound=False)
        assert unfused["segment_trapz"] > 0
        assert unfused["ordered_segment_sum"] > 0
        torchback.FUSED = True
        zones = _drive(lambda: mixed_fleet_scenario(
            Breakeven, "warm-first", seed=100,
            fleet="2xh100@DEU+2xa100@USA+2xl40s@IND", carbon_trace="zone"),
            "3-zone pinned day (fused)")
        G = shapes["fused_meter"][1][0]
        assert zones["fused_meter"] > 0 and G > 1, G
    finally:
        torchback.ops.fused_meter = real_fm
        torchback.FUSED = True
    return main, unfused


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fail before printing without the port)
    card = _card_line()
    print(card)
    build()
    stats = check_kernels()
    main_counts, unfused_counts = drive_days()
    src = "src/repro_torch/kernels/csrc/segment_trapz.cu"
    replaces = {
        "fused_meter": "src/repro/kernels/segment_trapz.py:66",
        "segment_trapz": "src/repro/kernels/segment_trapz.py:40",
        # not a Pallas kernel: the jax.ops.segment_sum it replaces
        "ordered_segment_sum": "src/repro/fleet/mega/jaxback.py:236",
    }
    launches = {"fused_meter": main_counts["fused_meter"],
                "segment_trapz": unfused_counts["segment_trapz"],
                "ordered_segment_sum": main_counts["ordered_segment_sum"]}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
               for k, v in stats.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
