#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds every kernel against its plain PyTorch version on
the card, drives ``repro_torch.fleet.run_mega(backend="torch")`` on the
600-device, ~1M-request acceptance day and checks it against the port's
numpy backend, then serves Qwen2.5-7B and RecurrentGemma-9B through
``ServingEngine`` and ``repro_torch.launch.serve``.  Phases, in order:

  1. the card (``nvidia-smi`` name and power limit) and the build time
     (every source in parallel, with its ``ptxas`` register and spill
     lines per entry function), and the HGMMA (wgmma) instructions in the
     sm90 attention library's SASS where the toolkit has ``cuobjdump``;
  2. each metering kernel against its plain version: ``fused_meter`` at
     small and acceptance-day shapes (``e``/``s`` bit-equal, ``c``/``fa``
     within 1e-12 relative); ``segment_trapz`` bit-equal at N in {1, 17,
     2001, tile - 1, tile, tile + 1, 3 tiles + 1, one persistent wave
     +- 1, the acceptance day's N - 1 (odd) and N}, a zero-width entry
     exactly 0, and a view off the 16-byte grid refused;
     ``ordered_segment_sum`` bit-equal at n in {0, 1, 1000, N} with
     uniform keys, with 90 % of the keys on one key, and at 15,000 keys,
     and refused above its key limit; planted faults modelled in plain
     torch (the ring read one tile late; each key's run summed in
     reverse, and as a pairwise tree) must fail those checks, and the
     count each gets wrong is printed.  Then the three public wrappers'
     CUDA-event times at the acceptance day's shapes (per call, median
     of 7 rounds of 20 calls, each round queued behind a spin kernel so
     the events time the card and not the host's launches, rotating
     over input sets of >= 100 MB so no call reads the L2), beside the
     least time the card could take: the larger of the bytes over the
     HBM rate, the FP64-pipe instructions (counted per entry in the
     kernels' SASS) over 132 SMs x 64 a clock at the top clock, and for
     ``ordered_segment_sum`` the longest run times the latency of one
     dependent FP64 add (measured by a one-thread chain);
  3. the acceptance day on the fused lane (the metering path), with the
     launch counters reset just before it and read just after;
  4. the unfused lane on a 24-route day, then the 3-zone pinned day
     (several carbon traces in one fused launch);
  5. the attention kernels against their plain versions (the
     reference's shape sweeps in float32 and bfloat16, tolerance 2e-3 /
     2e-2; rows past ``length`` ignored to 1e-5; the launcher's ragged
     shapes through permuted cache views), each prefill asserting the
     route that took it: bfloat16 at D in {32, 64, 128, 256} the sm90
     kernel (wgmma + TMA), float32 the simt kernel (FP32 FMAs); then
     the sm90 route at RecurrentGemma's heads (16 over 1, D = 256,
     S = T = 300, window None and 64), at both launchers' 3-token
     prompts against 48 cache rows through views, and without the
     causal mask; then the split-KV ``decode_attention`` (each call's
     route asserted): the timed Qwen shape with ragged lengths [4096,
     1000, 17, 1] (splits wholly past a row's length), a row of length 0
     (exactly 0, where the plain version gives NaN), RecurrentGemma's
     decode shape at T = 2048, and two calls bit-equal, with unit-normal
     queries and with queries x4, whose peaked softmax lets the check
     see the combine: two wrong combines of the same partials, modelled
     in plain torch, must fail it; then the times,
     each beside the bound (a kernel time under it fails the run), the
     plain version and ``scaled_dot_product_attention`` under every
     backend that takes it (the fastest is the yardstick):
     ``decode_attention`` (the split and the single route on the same
     inputs) at the Qwen shape B=4, T=4096, RecurrentGemma's B=4,
     T=2048, D=256, and both launchers' B=4, T=48 through views, the
     kernel and the library each rotating over input sets of >= 100 MB
     so that no call finds its cache in the 50 MB L2 (the back-to-back
     time of one set beside it); and bf16 ``flash_attention`` (the sm90
     and the simt kernel on the same inputs) at the 2048-token Qwen and
     RecurrentGemma prompts and at both launchers' prefill shapes;
  6. Qwen2.5-7B's widths at depth 2 in float32, the same weights served
     on the card and on the CPU: logits within 2e-3 of their max
     magnitude, greedy tokens equal; each side's prefill logits beside a
     float64 CPU run; then a bf16 prefill of 300 tokens with the kernels
     and with the plain flash attention swapped in, each against float32
     on the card: the kernel run no farther than 2x the plain one; then
     one bf16 ``decode_step`` at a 2048-row context (the split route):
     each layer's decode against the plain version on the model's views,
     where the two wrong combines must fail, and the logits within 2e-2
     of their max of the same step with the plain ``decode_attention``;
  7. the launcher (the serving path) at full width and depth on the
     card, counters reset just before it and read just after: exactly
     28 ``flash_attention`` launches per prefill, all on the sm90
     route, and 28 ``decode_attention`` launches per decode step, all
     on the single route, and the energy line equal to the
     ``--reduced`` run on the CPU;
  8. a ``torch.profiler`` breakdown of the card's kernel time over three
     served requests at full width, beside their host-clock time;
  9. ``rglru_scan`` against its plain version on both routes, the
     serial and the chunked kernel, at the reference's three shapes,
     the launcher's [1,3,4096] and [4,1,4096] and a 2048-token prompt
     [1,2048,4096] with a channel at a = 0.9999 (the carry's drift), in
     float32 and bfloat16 (tolerance 1e-4 / 3e-2), two chunked calls
     bit-equal, and the carried ``h0``; its times (both routes on the
     same inputs) on the 2048-token prompt and at the launcher's
     shapes; and windowed decode (``decode_attention`` over a view of
     the window's cache rows) against the plain windowed attention at
     RecurrentGemma's heads;
  10. RecurrentGemma-9B's widths at depth 3 (one RG-LRU, RG-LRU, local
      attention superlayer, the window cut to 16) in float32, card
      against CPU, then in bf16 against float32, as phase 6 (its
      300-token prefill's scans on the chunked route);
  11. the RecurrentGemma launcher at full width and depth (38 layers)
      on the card, counted as phase 7: exactly 26 ``rglru_scan`` and 12
      ``flash_attention`` launches per prefill, 26 ``rglru_scan`` and 12
      ``decode_attention`` per decode step, every scan on the serial
      route and every decode on the single one; then its profile, as
      phase 8;
  12. one JSON line describing every kernel (the metering rows: the
      input sets, FP64 instructions an entry or the longest run and the
      dependent-add latency; the flash row: the sm90
      kernel's time, the simt kernel's beside it, and every timed
      prefill shape; the decode row: the single route's time beside the
      split route's, the back-to-back time, and every timed shape; the
      scan row: the serial route's time beside the chunked one's, and
      every timed shape);
  13. as the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line.  It also exits non-zero without a CUDA device.
``python3 chip_smoke.py --metering`` stops after phase 4 and prints the
metering kernels' figures as one JSON line instead of the last two.
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

# NVIDIA H100 data sheet: memory bandwidth, FP64 and FP32 (non-tensor)
# peaks and dense BF16 tensor-core peak per form factor, matched against
# torch.cuda.get_device_name().
_PEAKS = (("PCIe", 2.0e12, 26e12, 51e12, 756e12),
          ("NVL", 3.9e12, 30e12, 60e12, 835e12),
          ("", 3.35e12, 34e12, 67e12, 989e12))


def _peaks(name):
    for key, bw, fp64, fp32, bf16 in _PEAKS:
        if key in name:
            return bw, {"fp64": fp64, "fp32": fp32, "bf16": bf16}
    raise AssertionError("unreachable")


def _bound_ms(name, nbytes, flops, kind="fp64"):
    bw, peak = _peaks(name)
    t_bytes, t_ops = nbytes / bw, flops / peak[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def _busy_card(torch):
    """Keep the card busy for about 2.5 ms (a spin kernel) while the host
    enqueues the calls of a timed round: the events around the round
    then time the card's work, not the rate at which the host launches
    (a wrapper or a ctypes call costs the host microseconds, as much as
    a small kernel takes the card)."""
    torch.cuda._sleep(5_000_000)


def _time_ms(fn, torch, reps=20, rounds=7):
    """Per-call CUDA-event time of ``fn``: back-to-back calls, the L2
    flushed before each round (``_time_rot`` over one function)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEV)
    return _time_rot([fn], torch, reps, rounds, flush=flush)


def _time_rot(fns, torch, reps=20, rounds=7, flush=None):
    """Per-call CUDA-event time of calls that take ``fns`` in turn (each
    on its own input set where there are several: together >=
    ROTATE_BYTES, so no call finds its inputs in the L2 the calls before
    it left): events around ``reps`` calls queued behind ``_busy_card``,
    ``flush`` (if given) zeroed before each round, median over
    ``rounds`` after a warm-up pass over all."""
    for fn in fns:
        fn()
    times, i = [], 0
    for _ in range(rounds):
        if flush is not None:
            flush.zero_()
        _busy_card(torch)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[i % len(fns)]()
            i += 1
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


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
            if any(w in line for w in ("registers", "spill", "entry")):
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


def _sort_inputs(n, num, seed, torch, hot=None):
    """vals [2, n] and keys [n] int64 uniform over [0, num) (or, with
    ``hot``, 90 % of them on key ``hot``: a flash crowd on one device)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num, n)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    vals = rng.uniform(0.0, 5e5, (2, n))
    return torch.from_numpy(vals).to(DEV), torch.from_numpy(keys).to(DEV)


def metering_sets(torch):
    """The three metering wrappers' timed inputs at the acceptance day's
    shapes, each a list of input sets that together hold at least
    ROTATE_BYTES (so no call finds its inputs in the L2).  Returns
    {name: (calls, bytes one call must move, the first set, extra)}:
    ``calls`` are thunks of the public wrappers of the ``repro_torch``
    on the path; ``extra`` is the knot tables, or for
    ``ordered_segment_sum`` thunks of ``index_add_`` on the same sets."""
    from repro_torch.fleet import make_trace
    from repro_torch.kernels import segment_trapz as cu

    tr = make_trace("solar-duck", 0.39)
    tabs = _tables([tr], torch)
    K = tabs[0].shape[1]
    one = (4 * 8 + 4) * N_METER + 4 * 8 * N_METER + (3 * K + 1) * 8
    fm = [_entries(N_METER, 1000 + j, 1, torch) for j in range(_sets(one))]
    fm_calls = [lambda s=s: cu.fused_meter(*s, *tabs) for s in fm]
    kt, kv, cum = tabs[0][0], tabs[1][0], tabs[2][0]
    one_s = 4 * 8 * N_SEG + 3 * K * 8
    st = [_entries(N_SEG, 2000 + j, 1, torch) for j in range(_sets(one_s))]
    st_calls = [lambda s=s: cu.segment_trapz(s[0], s[1], s[3], kt, kv, cum,
                                             period=tr.period_s)
                for s in st]
    num = N_DEV * 3
    one_o = 3 * 8 * N_METER + 2 * num * 8
    os_ = [_sort_inputs(N_METER, num, 3000 + j, torch)
           for j in range(_sets(one_o))]
    os_calls = [lambda s=s: cu.ordered_segment_sum(*s, num) for s in os_]
    lib = [lambda s=s: torch.zeros(2, num, dtype=torch.float64, device=DEV)
           .index_add_(1, s[1], s[0]) for s in os_]
    return {"fused_meter": (fm_calls, one, fm[0], tabs),
            "segment_trapz": (st_calls, one_s, st[0], (kt, kv, cum, tr)),
            "ordered_segment_sum": (os_calls, one_o, os_[0], lib)}


def time_metering(torch, sets=None):
    """Rotated, spin-queued CUDA-event time of each metering wrapper
    (``_time_rot`` over ``metering_sets``).  Returns {name: ms}."""
    sets = sets or metering_sets(torch)
    return {k: _time_rot(v[0], torch) for k, v in sets.items()}


# FP64-pipe opcodes counted in a kernel's SASS (an H100 SM issues 64 a
# clock: the data sheet's 34 TFLOP/s FP64 / 2 / 132 SMs / 1.98 GHz)
_FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET", "FRND",
             "MUFU.RCP64H", "MUFU.RSQ64H", "F2F", "F2I", "I2F")


def _sass_functions(lib):
    """{mangled name: [SASS lines]} of a built library (``cuobjdump``
    beside ``nvcc``)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    assert tool.exists(), "cuobjdump not found beside nvcc"
    sass = subprocess.run([str(tool), "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def _fp64_ops(lines):
    """FP64-pipe instructions of one function's SASS by opcode, leaving
    out the subroutines it CALLs (the divide's rarely taken slow path).
    F2F, F2I and I2F count only with an F64 operand type."""
    import re
    text = "\n".join(lines)
    called = set(re.findall(r"CALL\.REL[.A-Z]*\s+`\((\.L_x_\d+)\)", text))
    counts, skip = {}, False
    for line in lines:
        label = line.strip().rstrip(":")
        if line.strip().endswith(":") and label in called:
            skip = True
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        if not skip:
            for k in _FP64_OPS:
                if op == k or op.startswith(k + "."):
                    if k in ("F2F", "F2I", "I2F") and "F64" not in op:
                        break
                    counts[k] = counts.get(k, 0) + 1
                    break
        elif op.startswith("RET"):
            skip = False
    return counts


def fp64_per_entry(kernel, K):
    """FP64-pipe instructions a metering kernel issues per entry, read
    from its SASS (its instantiation for K knots; a loop's body, as
    fused_meter's bisect, counts once, so the count is a lower one, and
    the bound it gives still a least time): every entry does four
    IEEE divides, each one MUFU.RCP64H on its fast path, so the code
    holds the body of round(RCP64H / 4) entries (one in fused_meter's
    loop, four in segment_trapz's tile), whatever the compiler unrolled.
    The function's SASS is written to ``chiprun_out/<kernel>.sass``.
    Returns (per entry, {opcode: count over the code})."""
    steps = max(1, (K - 1).bit_length())
    funcs = _sass_functions("segment_trapz")
    (name,) = [f for f in funcs if f"{kernel}ILi{steps}E" in f] or \
        [f for f in funcs if f"{kernel}E" in f]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{kernel}.sass").write_text("\n".join(funcs[name]))
    ops = _fp64_ops(funcs[name])
    entries = round(ops.get("MUFU.RCP64H", 0) / 4)
    assert entries >= 1, (name, ops)
    return sum(ops.values()) / entries, ops


def _clock_hz():
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``): the
    FP64 term of a bound at this clock is the least time."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.split()[0]) * 1e6


def _bound_terms(terms):
    """The largest of ``terms`` ({term: ms}) and its name."""
    by = max(terms, key=terms.get)
    return terms[by], by


def dadd_latency_ms(torch, steps=1 << 20):
    """The latency of one dependent FP64 add on the card: one thread
    adding ``steps`` times (``dadd_chain_f64``), CUDA events around it."""
    from repro_torch.kernels import segment_trapz as cu
    out = torch.empty(1, dtype=torch.float64, device=DEV)
    fn = cu._fn("dadd_chain_f64")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1024, steps):                 # a warm-up, then the timed run
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        assert fn(1.0, n, out.data_ptr(), stream) == 0
        stop.record()
    stop.synchronize()
    assert float(out) == float(steps)
    return start.elapsed_time(stop) / steps


def _sees(got, want, faults, label, axis=None):
    """A check that must be able to fail: ``got`` equals ``want`` bit
    for bit and each planted fault does not.  Returns {fault: how many
    entries (``axis=None``) or keys (``axis=0``: columns) it gets
    wrong}."""
    import torch
    assert torch.equal(got, want), f"{label}: not bit-equal to the plain"
    wrong = {}
    for name, bad in faults.items():
        diff = bad != want
        if axis is not None:
            diff = diff.any(axis)
        wrong[name] = int(diff.sum())
        assert wrong[name] > 0, f"{label}: the check passes {name}"
    return wrong


def check_kernels(quick=False):
    """Phase 2: every metering kernel against its plain version on the
    card, then (unless ``quick``) their times and bounds."""
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
    tr = make_trace("solar-duck", 0.39)
    kt, kv, cum = (torch.tensor(x, dtype=torch.float64, device=DEV)
                   for x in (tr._kt, tr._kv, tr._cum))
    K = len(tr._kt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = cu.TRAPZ_TILE
    wave = cu.trapz_plan(10**9, sms).blocks * tile   # one persistent wave
    sizes = [1, 17, 2001, tile - 1, tile, tile + 1, 3 * tile + 1]
    if not quick:
        sizes += [wave - 1, wave, wave + 1, N_SEG - 1, N_SEG]
    for n in sizes:
        a, b, _dt, w, _g = _entries(n, n, 1, torch)
        got = ops.segment_trapz(a, b, w, kt, kv, cum, period=tr.period_s)
        want = ref.segment_trapz_ref(a, b, w, kt, kv, cum,
                                     period=tr.period_s)
        torch.cuda.synchronize()
        plan = cu.trapz_plan(n, sms)
        faults = ref.segment_trapz_faults(want, tile, plan.full_tiles) \
            if plan.full_tiles > 1 else {}
        wrong = _sees(got, want, faults, f"segment_trapz N={n}")
        assert float(got[n // 2]) == 0.0            # the zero-width entry
        seen = "".join(f"; {k} gets {v} entries wrong"
                       for k, v in wrong.items())
        print(f"segment_trapz N={n:>7} ({plan.blocks} blocks, "
              f"{plan.full_tiles} ring tiles + {plan.tiles - plan.full_tiles}"
              f" tail): bit-equal{seen}")
        stats["segment_trapz"] = {"max_abs_err": 0.0, "n": n}
    try:
        ops.segment_trapz(a[1:], b[1:], w[1:], kt, kv, cum,
                          period=tr.period_s)
    except ValueError as e:
        print(f"segment_trapz on a view off the 16-byte grid raises: {e}")
    else:
        raise AssertionError("segment_trapz took a misaligned view")

    num = N_DEV * 3
    cases = [("uniform", n, num, None) for n in (0, 1, 1000, big_m)]
    if not quick:
        cases += [("90 % on one key", 100_000, num, 7),
                  ("uniform", N_METER, 15_000, None)]
    for kind, n, nk, hot in cases:
        vals, keys = _sort_inputs(n, nk, n + nk, torch, hot)
        got = ops.ordered_segment_sum(vals, keys, nk)
        # the plain version loops over the longest run: on the CPU for
        # the skewed keys (90,000 steps), on the card otherwise
        on = "cpu" if hot is not None else DEV
        want = ref.ordered_segment_sum_ref(vals.to(on), keys.to(on), nk)
        faults = ref.ordered_segment_sum_faults(
            vals.to(on), keys.to(on), nk) if n >= 100_000 else {}
        torch.cuda.synchronize()
        wrong = _sees(got.to(on), want, faults,
                      f"ordered_segment_sum {kind} N={n} num={nk}", axis=0)
        run = int(torch.bincount(keys, minlength=nk).max()) if n else 0
        seen = "".join(f"; {k} gets {v} keys wrong"
                       for k, v in wrong.items())
        print(f"ordered_segment_sum {kind} N={n:>7} num={nk} (tiles of "
              f"{cu.sort_plan(n, nk).tile}, longest run {run}): "
              f"bit-equal{seen}")
        if n == big_m and nk == num:
            stats["ordered_segment_sum"] = {"max_abs_err": 0.0, "n": n}
    try:
        cu.ordered_segment_sum(vals, keys, cu.SORT_MAX_NUM + 1)
    except ValueError as e:
        print(f"ordered_segment_sum above its key limit raises: {e}")
    else:
        raise AssertionError("ordered_segment_sum took too many keys")
    if quick:
        return stats

    # times at the acceptance day's shapes, rotated, beside the least time
    sets = metering_sets(torch)
    times = time_metering(torch, sets)
    clock = _clock_hz()
    fp64_rate = sms * 64 * clock                   # instructions a second
    bw = _peaks(name)[0]
    dadd_ms = dadd_latency_ms(torch)
    print(f"FP64 pipe: {sms} SMs x 64 a clock x {clock / 1e6:.0f} MHz; "
          f"one dependent FP64 add {dadd_ms * 1e6:.3f} ns (one-thread "
          f"chain)")
    for k in ("fused_meter", "segment_trapz"):
        t = stats[k]
        calls, nbytes = sets[k][:2]
        per, ops_by = fp64_per_entry(k + "_kernel", K)
        t.update(ms=times[k], sets=len(calls), fp64_per_entry=per,
                 library_ms=None, n=N_METER if k == "fused_meter" else N_SEG)
        t["bound_ms"], t["bound_by"] = _bound_terms({
            "bytes": nbytes / bw * 1e3,
            "operations": per * t["n"] / fp64_rate * 1e3})
        print(f"{k} SASS (K={K}): {per:.2f} FP64-pipe instructions an "
              f"entry; over the code {ops_by}")
    a, b, dt, w, g = sets["fused_meter"][2]
    tabs = sets["fused_meter"][3]
    stats["fused_meter"]["plain_ms"] = _time_ms(
        lambda: ref.fused_meter_ref(a, b, dt, w, g, *tabs), torch, reps=3)
    a, b, _dt, w, _g = sets["segment_trapz"][2]
    stats["segment_trapz"]["plain_ms"] = _time_ms(
        lambda: ref.segment_trapz_ref(a, b, w, kt, kv, cum,
                                      period=tr.period_s), torch, reps=3)
    t = stats["ordered_segment_sum"]
    calls, nbytes, (vals, keys), lib = sets["ordered_segment_sum"]
    t.update(ms=times["ordered_segment_sum"], sets=len(calls),
             longest_run=int(torch.bincount(keys, minlength=num).max()),
             dadd_ns=dadd_ms * 1e6)
    t["plain_ms"] = _time_ms(lambda: ref.ordered_segment_sum_ref(
        vals, keys, num), torch, reps=1, rounds=3)
    t["bound_ms"], t["bound_by"] = _bound_terms({
        "bytes": nbytes / bw * 1e3,
        "operations": vals.numel() / fp64_rate * 1e3,
        "dependent adds": t["longest_run"] * dadd_ms})
    t["library_ms"] = _time_rot(lib, torch)
    for k, v in stats.items():
        lib_ms = v["library_ms"]
        print(f"time {k:20s} N={v['n']}: kernel {v['ms']!r} ms rotating "
              f"over {v['sets']} input sets, plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']!r} ms ({v['bound_by']}), library "
              f"{'n/a' if lib_ms is None else repr(lib_ms) + ' ms'}")
        _possible(v["ms"], v["bound_ms"], k)
    return stats


# ---------------------------------------------------------------------------
# attention kernels and the serving path
# ---------------------------------------------------------------------------

ARCH = "qwen2-5-7b"
# the reference's attention contract (tests/test_kernels.py)
FLASH_SHAPES = ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 256, 128),
                (2, 2, 2, 512, 32))                     # (B, H, Hkv, S, D)
DECODE_SHAPES = ((1, 4, 4, 256, 64), (2, 8, 2, 512, 64),
                 (4, 8, 1, 1024, 128))                  # (B, H, Hkv, T, D)
ATTN_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
REL_LOGITS = 2e-3          # card vs CPU logits, relative to their max
# decode timing shape: 4 decode rows over 4096 rows (the prefill rows
# are FLASH_ROWS), its ragged lengths, and RecurrentGemma's decode over
# its 2048-row window
DECODE_TIMED = (4, 28, 4, 4096, 128)
DECODE_RAGGED = (4096, 1000, 17, 1)
RG_DECODE = (4, 16, 1, 2048, 256)
RG_RAGGED = (2048, 700, 64, 3)
# bf16 decode timing rows: (label, B, H, Hkv, T, D, length, views);
# ``views``: k, v read through [B,T,Hkv,D] tensors, as the launcher's
# decode steps hand them over (position 5 of a 48-row cache)
DECODE_ROWS = (
    ("qwen 4096", *DECODE_TIMED, 4096, False),
    ("recurrentgemma 2048", *RG_DECODE, 2048, False),
    ("qwen launcher", 4, 28, 4, 48, 128, 6, True),
    ("recurrentgemma launcher", 4, 16, 1, 48, 256, 6, True),
)
# input sets a timed call rotates over: together at least this many
# bytes, twice the 50 MB L2, so no call finds its inputs there
ROTATE_BYTES = 100_000_000

RG_ARCH = "recurrentgemma-9b"
# the reference's rglru_scan contract (tests/test_kernels.py), then the
# launcher's shapes: a 3-token prefill and a 4-row decode step at W=4096
RGLRU_SHAPES = ((1, 128, 128), (2, 256, 256), (3, 384, 128))   # (B, S, W)
RGLRU_RAGGED = ((1, 3, 4096), (4, 1, 4096))
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RGLRU_TIMED = (1, 2048, 4096)          # a long RecurrentGemma prompt, f32
RGLRU_ROWS = (RGLRU_TIMED,) + RGLRU_RAGGED   # timed, f32
RG_WINDOW = 16                         # the depth-3 run's cut window


def _randn(shape, seed, dtype, torch):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _close(got, want, tol):
    """Whether |got - want| <= tol + tol * |want| elementwise (the
    reference's assert_allclose(rtol=tol, atol=tol)) with got finite, and
    the max abs error."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.all(err <= tol + tol * w.abs()))
    return ok and bool(torch.isfinite(g).all()), float(err.max())


def _attn_close(got, want, tol, label):
    """``_close`` or fail; returns the max abs error."""
    ok, err = _close(got, want, tol)
    assert ok, f"{label}: max abs err {err:.3e} beyond {tol}"
    return err


def _sees_combine(q, k, v, length, want, tol, label):
    """The split route's check must be able to fail a wrong combine:
    the kernel's own plan's partials, modelled in plain torch
    (``ref.decode_split_partials``), combined the two wrong ways of
    ``ref.decode_split_faults`` (splits weighted equally; each split left
    on its own max), must each fail ``_close(., want, tol)``.  Returns
    their max abs errors."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ref
    b, h, d = q.shape
    pl = dmod.plan(b, h, k.shape[1], k.shape[2], d, dmod._sms(q.device))
    parts = ref.decode_split_partials(q, k, v, length, pl.chunk)
    errs = {}
    for name, out in ref.decode_split_faults(*parts, q.dtype).items():
        ok, errs[name] = _close(out, want, tol)
        assert not ok, (f"{label}: the check passes a combine with "
                        f"{name} (max abs err {errs[name]:.3e})")
    return errs


def _routed(op, way, call):
    """``call()``, asserting that it made one call of ``op`` and that
    the call took route ``way`` (``ops.route_counts(op)``)."""
    from repro_torch.kernels import ops
    before = ops.route_counts(op)
    out = call()
    after = ops.route_counts(op)
    assert after[way] == before[way] + 1 and sum(after.values()) == sum(
        before.values()) + 1, (op, way, before, after)
    return out


def _flash_routed(q, k, v, window, causal=True):
    """``ops.flash_attention``, asserting that the route the wrapper
    names for q's dtype and head dim took the launch."""
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops
    return _routed("flash_attention", fmod.route(q.dtype, q.shape[-1]),
                   lambda: ops.flash_attention(q, k, v, causal=causal,
                                               window=window))


# bf16 checks of the sm90 route beyond the reference's sweep:
# (B, H, Hkv, S, T, D, window, views, causal) -- RecurrentGemma's heads
# at a ragged S = T = 300; the launcher's 3-token prompt against 48 cache
# rows, read through [B,S|T,heads,D] views, at both models' heads; and
# the non-causal mask the wrapper also takes, with T below and above S
# (every row sees a key: where none is visible the plain version gives
# NaN and the kernels 0)
SM90_CASES = (
    (1, 16, 1, 300, 300, 256, None, False, True),
    (1, 16, 1, 300, 300, 256, 64, False, True),
    (1, 28, 4, 3, 48, 128, None, True, True),
    (1, 16, 1, 3, 48, 256, 2048, True, True),
    (2, 8, 2, 300, 200, 128, None, False, False),
    (2, 4, 4, 200, 300, 64, 64, False, False),
)


def check_flash_sm90(stats):
    """The bf16 sm90 route (``csrc/flash_attention_sm90.cu``) against the
    plain version at SM90_CASES, 2e-2; every call must take the sm90
    route.  (The reference's sweep in ``check_attention`` covers D = 32,
    64 and 128 on this route in bf16.)"""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref

    dt, tol = torch.bfloat16, ATTN_TOL["bfloat16"]
    for i, (b, h, hkv, s, t, d, window, views, causal) in \
            enumerate(SM90_CASES):
        assert fmod.route(dt, d) == "sm90"
        if views:
            q = _randn((b, s, h, d), 70 + i, dt, torch).transpose(1, 2)
            k = _randn((b, t, hkv, d), 80 + i, dt, torch).transpose(1, 2)
            v = _randn((b, t, hkv, d), 90 + i, dt, torch).transpose(1, 2)
        else:
            q = _randn((b, h, s, d), 70 + i, dt, torch)
            k = _randn((b, hkv, t, d), 80 + i, dt, torch)
            v = _randn((b, hkv, t, d), 90 + i, dt, torch)
        got = _flash_routed(q, k, v, window, causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        err = _attn_close(got, want, tol, f"sm90 flash {SM90_CASES[i]}")
        stats["flash_attention"]["max_abs_err"] = max(
            stats["flash_attention"]["max_abs_err"], err)
        print(f"flash_attention  sm90 bf16 B,H,Hkv,S,T,D="
              f"{(b, h, hkv, s, t, d)} window={window} views={views} "
              f"causal={causal}: max abs err {err:.3e} (tol {tol})")


def count_hgmma():
    """The HGMMA (wgmma) instructions in the sm90 library's SASS, read
    with the toolkit's ``cuobjdump`` where it has one (None otherwise)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("cuobjdump not found beside nvcc: the sm90 library's HGMMA "
              "count is not read")
        return None
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.lib_path("flash_attention_sm90"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"flash_attention_sm90 SASS: {n} HGMMA instructions")
    assert n > 0, "the sm90 library holds no wgmma"
    return n


def check_attention():
    """The attention kernels against their plain versions on the card:
    the reference's shape sweeps, the frontier case, and the launcher's
    ragged shapes through permuted cache views.  Returns the max abs
    error of each kernel over all cases."""
    import torch

    from repro_torch.kernels import ops, ref

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        for b, h, hkv, s, d in FLASH_SHAPES:
            q = _randn((b, h, s, d), 0, dt, torch)
            k = _randn((b, hkv, s, d), 1, dt, torch)
            v = _randn((b, hkv, s, d), 2, dt, torch)
            for window in (None, 64):
                got = _flash_routed(q, k, v, window)
                want = ref.flash_attention_ref(q, k, v, causal=True,
                                               window=window)
                torch.cuda.synchronize()
                assert got.shape == q.shape and got.dtype == dt
                err = _attn_close(got, want, tol,
                                  f"flash {dt} {(b, h, hkv, s, d)} "
                                  f"window={window}")
                worst["flash_attention"] = max(worst["flash_attention"], err)
                print(f"flash_attention  {str(dt):14s} B,H,Hkv,S,D="
                      f"{(b, h, hkv, s, d)} window={window}: max abs err "
                      f"{err:.3e} (tol {tol})")
        for b, h, hkv, t, d in DECODE_SHAPES:
            q = _randn((b, h, d), 0, dt, torch)
            k = _randn((b, hkv, t, d), 1, dt, torch)
            v = _randn((b, hkv, t, d), 2, dt, torch)
            g = torch.Generator().manual_seed(t)
            length = torch.randint(1, t, (b,), generator=g,
                                   dtype=torch.int32).to(DEV)
            got = ops.decode_attention(q, k, v, length)
            want = ref.decode_attention_ref(q, k, v, length)
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.dtype == dt
            err = _attn_close(got, want, tol,
                              f"decode {dt} {(b, h, hkv, t, d)}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            print(f"decode_attention {str(dt):14s} B,H,Hkv,T,D="
                  f"{(b, h, hkv, t, d)} length={length.tolist()}: max abs "
                  f"err {err:.3e} (tol {tol})")
        # the launcher's shapes: a 3-token prompt against 48 cache rows,
        # and a decode at position 5, both read through [B,T,Hkv,D] views
        q = _randn((1, 3, 28, 128), 3, dt, torch)
        k = _randn((1, 48, 4, 128), 4, dt, torch)
        v = _randn((1, 48, 4, 128), 5, dt, torch)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = _flash_routed(qt, kt, vt, None)
        want = ref.flash_attention_ref(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        err = _attn_close(got, want, tol, f"flash {dt} S=3 T=48")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        kb = _randn((4, 48, 4, 128), 6, dt, torch).transpose(1, 2)
        vb = _randn((4, 48, 4, 128), 7, dt, torch).transpose(1, 2)
        qd = _randn((4, 28, 128), 8, dt, torch)
        length = torch.full((4,), 6, dtype=torch.int32, device=DEV)
        got = ops.decode_attention(qd, kb, vb, length)
        want = ref.decode_attention_ref(qd, kb, vb, length)
        torch.cuda.synchronize()
        err2 = _attn_close(got, want, tol, f"decode {dt} T=48 length=6")
        worst["decode_attention"] = max(worst["decode_attention"], err2)
        print(f"launcher shapes  {str(dt):14s} flash S=3 T=48 err {err:.3e}; "
              f"decode B=4 T=48 length=6 err {err2:.3e} (tol {tol})")
    # garbage past the frontier must not change the output
    b, h, hkv, t, d = 1, 4, 2, 256, 64
    q = _randn((b, h, d), 0, torch.float32, torch)
    k = _randn((b, hkv, t, d), 1, torch.float32, torch)
    v = _randn((b, hkv, t, d), 2, torch.float32, torch)
    out1 = ops.decode_attention(q, k, v, 100)
    k[:, :, 100:] = 1e4
    v[:, :, 100:] = -1e4
    out2 = ops.decode_attention(q, k, v, 100)
    torch.cuda.synchronize()
    diff = float((out1 - out2).abs().max())
    assert diff <= 1e-5, f"decode reads past length: {diff:.3e}"
    print(f"decode_attention ignores rows past length: max diff {diff:.3e}")
    return {k: {"max_abs_err": v} for k, v in worst.items()}


def _raw_attn(mod, lib, fn_name, sig, strides, *args):
    """A call of one attention or RG-LRU C entry point (``fn(*args,
    strides, stream)``) with a preallocated output (no checks, no
    allocation, no launch count)."""
    import ctypes

    import torch
    fn = mod.c_fn(lib, fn_name, sig)
    arr = (ctypes.c_longlong * len(strides))(*strides)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(*args, arr, stream)
        if rc != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {rc}")

    return run


def _sets(nbytes):
    """Input sets of ``nbytes`` each to rotate over: at least two, and
    together at least ROTATE_BYTES."""
    return max(2, -(-ROTATE_BYTES // nbytes))


def _possible(ms, bound, label):
    """A kernel time under the least time the card could take is a
    timing fault (an input read from cache, work skipped): fail."""
    assert ms >= bound, (f"{label}: {ms} ms is under the bound {bound} ms; "
                         f"impossible")


def _raw_decode(q, k, v, length, out, pl):
    """One raw call of the decode kernel with plan ``pl`` (no checks, no
    count; its partials' scratch allocated here and kept by the call)."""
    import math

    import torch

    from repro_torch.kernels import decode_attention as dmod
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    acc = ml = None
    if pl.splits > 1:
        acc = torch.empty((b, h, pl.splits, d), dtype=torch.float32,
                          device=DEV)
        ml = torch.empty((b, h, pl.splits, 2), dtype=torch.float32,
                         device=DEV)
    run = _raw_attn(
        dmod, "decode_attention", "decode_attention_fwd", dmod._SIG,
        [*q.stride(), *k.stride(), *v.stride(), *out.stride()],
        1 if q.dtype == torch.bfloat16 else 0,
        int(dmod.tensor_cores(q.dtype, d)), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), length.data_ptr(), out.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        ml.data_ptr() if ml is not None else None, b, h, hkv, t, d,
        pl.splits, pl.chunk, 1.0 / math.sqrt(d))
    run.scratch = (acc, ml)
    return run


def _decode_routed(q, k, v, length, way):
    """``ops.decode_attention``, asserting that it took route ``way``."""
    from repro_torch.kernels import ops
    return _routed("decode_attention", way,
                   lambda: ops.decode_attention(q, k, v, length))


def check_decode_split(stats):
    """The split-KV route against the plain version at the timed Qwen
    shape with ragged lengths (whole splits past a row's length) and at
    RecurrentGemma's decode shape, in bfloat16 (the tensor cores) and
    float32 (FP32 FMAs), with unit-normal queries and with queries x4:
    there the softmax is peaked, a row spanning splits takes its value
    from a few keys, and the check must reject a wrong combine of the
    same plan's partials (``_sees_combine``); a row of length 0 gives
    exactly 0; two calls on the same inputs are bit-equal."""
    import torch

    from repro_torch.kernels import ops, ref

    for shape, lengths in ((DECODE_TIMED, DECODE_RAGGED),
                           (RG_DECODE, RG_RAGGED)):
        b, h, hkv, t, d = shape
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            k = _randn((b, hkv, t, d), 101, dt, torch)
            v = _randn((b, hkv, t, d), 102, dt, torch)
            length = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            for qs in (1, 4):
                q = _randn((b, h, d), 100, dt, torch) * qs
                got = _decode_routed(q, k, v, length, "split")
                want = ref.decode_attention_ref(q, k, v, length)
                again = ops.decode_attention(q, k, v, length)
                torch.cuda.synchronize()
                err = _attn_close(got, want, tol,
                                  f"split decode {dt} {shape} q x{qs}")
                assert torch.equal(got, again), "two calls differ"
                # a row of length 0: 0 (the plain version's empty softmax
                # is NaN), the other rows as before
                zero = torch.tensor((0,) + lengths[1:], dtype=torch.int32,
                                    device=DEV)
                got0 = _decode_routed(q, k, v, zero, "split")
                torch.cuda.synchronize()
                assert bool((got0[0] == 0).all()), "length 0 row is not 0"
                assert torch.equal(got0[1:], got[1:])
                seen = ""
                if qs > 1:
                    faults = _sees_combine(q, k, v, length, want, tol,
                                           f"split decode {dt} {shape}")
                    seen = "; the check rejects a wrong combine: " + \
                        ", ".join(f"{n} max abs err {e:.3e}"
                                  for n, e in faults.items())
                stats["decode_attention"]["max_abs_err"] = max(
                    stats["decode_attention"]["max_abs_err"], err)
                print(f"decode_attention split {str(dt):14s} B,H,Hkv,T,D="
                      f"{shape} length={list(lengths)} q x{qs}: max abs "
                      f"err {err:.3e} (tol {tol}), max|want| "
                      f"{float(want.float().abs().max()):.3e}; two calls "
                      f"bit-equal; a length-0 row exactly 0{seen}")


def time_attention(stats):
    """``decode_attention``'s time at every row of DECODE_ROWS (bf16):
    the split route the plan takes and, on the same inputs, the single
    route (one block a (b, kv head, query-head group)), each rotating
    over input sets of >= ROTATE_BYTES together; beside them the
    back-to-back time of one set (the earlier method, which reads
    a cache smaller than the L2 from there after the first call), the
    plain version, the bound (every kernel time must be at or above
    it) and ``scaled_dot_product_attention`` under its fastest backend,
    rotating alike (``flash_attention``'s rows are ``time_flash``'s).
    The Qwen 4096 row fills ``stats["decode_attention"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ref

    name = torch.cuda.get_device_name(0)
    dt = torch.bfloat16
    rows = []
    for i, (label, b, h, hkv, t, d, n, views) in enumerate(DECODE_ROWS):
        # queries x4: a peaked softmax, whose output a wrong combine
        # would miss by far more than the tolerance (check_decode_split)
        q = _randn((b, h, d), 200 + i, dt, torch) * 4
        sets = []
        for j in range(_sets(2 * b * hkv * t * d * 2)):
            if views:
                k = _randn((b, t, hkv, d), 300 + 2 * j, dt, torch)
                v = _randn((b, t, hkv, d), 301 + 2 * j, dt, torch)
                sets.append((k.transpose(1, 2), v.transpose(1, 2)))
            else:
                sets.append((_randn((b, hkv, t, d), 300 + 2 * j, dt, torch),
                             _randn((b, hkv, t, d), 301 + 2 * j, dt,
                                    torch)))
        length = torch.full((b,), n, dtype=torch.int32, device=DEV)
        want = ref.decode_attention_ref(q, *sets[0], length)
        pl = dmod.plan(b, h, hkv, t, d, dmod._sms(q.device))
        one = dmod.Plan(1, -(-t // dmod.TILE) * dmod.TILE)
        way = "split" if pl.splits > 1 else "single"
        row = {"label": label, "splits": pl.splits, "route": way,
               "shape": f"B,H,Hkv,T,D={(b, h, hkv, t, d)} length={n} "
                        f"views={views} bf16"}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, (2 * q.numel() + 2 * b * hkv * n * d) * 2,
            4 * b * h * n * d, "bf16")
        for route, p in (("split", pl), ("single", one)):
            if route == "split" and pl.splits == 1:
                continue
            outs = [torch.empty_like(q) for _ in sets]
            fns = [_raw_decode(q, k, v, length, o, p)
                   for (k, v), o in zip(sets, outs)]
            row[route] = _time_rot(fns, torch)
            torch.cuda.synchronize()
            row[route + "_err"] = _attn_close(outs[0], want, 2e-2,
                                              f"{route} decode at {label}")
            _possible(row[route], row["bound_ms"], f"{route} decode {label}")
            if route == way:
                row["l2_ms"] = _time_ms(fns[0], torch)
        row["plain_ms"] = _time_ms(
            lambda: ref.decode_attention_ref(q, *sets[0], length), torch,
            reps=5)
        calls = [lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k[:, :, :n], v[:, :, :n], enable_gqa=True)
            for k, v in sets]
        row["library_ms"], row["library"], row["backends"] = _library_ms(
            calls[0], torch, rotate=calls[1:])
        rows.append(row)
        times = ", ".join(f"{r} {row[r]:.4f} ms (err {row[r + '_err']:.3e})"
                          for r in ("split", "single") if r in row)
        bk = ", ".join(f"{k} {v:.4f}" for k, v in row["backends"].items())
        print(f"time decode_attention {label:24s} {row['shape']}, "
              f"{pl.splits} splits: {times}, each rotating over "
              f"{len(sets)} input sets; {way} back-to-back on one set "
              f"{row['l2_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
              f"({row['library']}; {bk})")
    top = rows[0]
    t = stats["decode_attention"]
    t.update(ms=top["split"], single_ms=top["single"], l2_ms=top["l2_ms"],
             plain_ms=top["plain_ms"], library_ms=top["library_ms"],
             library=top["library"], bound_ms=top["bound_ms"],
             bound_by=top["bound_by"], shape=top["shape"],
             splits=top["splits"])
    t["max_abs_err"] = max(t["max_abs_err"], top["split_err"],
                           top["single_err"])
    return rows


# bf16 prefill timing rows: (label, B, H, Hkv, S, T, D, window, views);
# ``views``: q, k, v read through [B,S|T,heads,D] tensors, as the
# launcher hands them over (a 3-token prompt against 48 cache rows)
FLASH_ROWS = (
    ("qwen 2048", 1, 28, 4, 2048, 2048, 128, None, False),
    ("recurrentgemma 2048", 1, 16, 1, 2048, 2048, 256, 2048, False),
    ("qwen launcher", 1, 28, 4, 3, 48, 128, None, True),
    ("recurrentgemma launcher", 1, 16, 1, 3, 48, 256, 2048, True),
)


def _flash_work(b, h, hkv, s, t, d, window):
    """Bytes and operations a causal (windowed) prefill needs: q, out
    and the kv rows some query sees, once each; 4 D operations per
    visible (query, key) pair."""
    pairs = sum(min(i + 1, t) - (max(0, i + 1 - window) if window else 0)
                for i in range(s))
    rows = min(s, t)
    return (2 * b * h * s * d + 2 * b * hkv * rows * d) * 2, \
        4 * b * h * pairs * d


def _library_ms(call, torch, rotate=()):
    """``call`` (one ``scaled_dot_product_attention``) timed under each
    backend of ``torch.nn.attention.sdpa_kernel`` that accepts it, in
    turn with the same call on the input sets ``rotate`` when given
    (``_time_rot``); returns (the fastest time, its backend, every
    backend's time)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that refuses the call warns why, then raises
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                call()
                torch.cuda.synchronize()
                times[be.name] = _time_rot([call, *rotate], torch, reps=5) \
                    if rotate else _time_ms(call, torch, reps=5)
        except RuntimeError:
            continue
    best = min(times, key=times.get)
    return times[best], best, times


def _raw_flash(q, k, v, out, window, route):
    """One raw call of the ``route`` kernel (no checks, no count)."""
    import math

    from repro_torch.kernels import flash_attention as fmod
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    return _raw_attn(fmod, *fmod.ENTRY[route], fmod._SIG,
                     [*q.stride(), *k.stride(), *v.stride(), *out.stride()],
                     1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, h, hkv, s, t, d, 1,
                     int(window or 0), 1.0 / math.sqrt(d))


def time_flash(stats, routes=("sm90", "simt")):
    """bf16 ``flash_attention`` at every row of FLASH_ROWS: each route's
    kernel (the wrapper takes the first; the simt kernel, which bf16 no
    longer reaches at these head dims, is timed on the same inputs), the
    plain version, the bound and ``scaled_dot_product_attention`` under
    its fastest backend.  The Qwen 2048 row fills
    ``stats["flash_attention"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    name = torch.cuda.get_device_name(0)
    dt = torch.bfloat16
    rows = []
    for i, (label, b, h, hkv, s, t, d, window, views) in \
            enumerate(FLASH_ROWS):
        if views:
            q = _randn((b, s, h, d), 40 + i, dt, torch).transpose(1, 2)
            k = _randn((b, t, hkv, d), 50 + i, dt, torch).transpose(1, 2)
            v = _randn((b, t, hkv, d), 60 + i, dt, torch).transpose(1, 2)
        else:
            q = _randn((b, h, s, d), 40 + i, dt, torch)
            k = _randn((b, hkv, t, d), 50 + i, dt, torch)
            v = _randn((b, hkv, t, d), 60 + i, dt, torch)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        row = {"label": label, "shape": f"B,H,Hkv,S,T,D={(b, h, hkv, s, t, d)}"
               f" window={window} bf16 causal"}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, *_flash_work(b, h, hkv, s, t, d, window), "bf16")
        for route in routes:
            out = torch.empty_like(q)
            reps = 5 if s > 512 else 20
            row[route] = _time_ms(_raw_flash(q, k, v, out, window, route),
                                  torch, reps=reps)
            torch.cuda.synchronize()
            row[route + "_err"] = _attn_close(out, want, 2e-2,
                                              f"{route} flash at {label}")
            _possible(row[route], row["bound_ms"], f"{route} flash {label}")
        row["plain_ms"] = _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window), torch, reps=2, rounds=3)
        # the window never bites at these shapes (S <= window), so the
        # library computes the same function with is_causal alone
        assert window is None or window >= s
        row["library_ms"], row["library"], row["backends"] = _library_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), torch)
        rows.append(row)
        times = ", ".join(f"{r} {row[r]:.4f} ms (err {row[r + '_err']:.3e})"
                          for r in routes)
        bk = ", ".join(f"{k} {v:.4f}" for k, v in row["backends"].items())
        print(f"time flash_attention {label:24s} {row['shape']}: {times}; "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), scaled_dot_product_attention "
              f"{row['library_ms']:.4f} ms ({row['library']}; {bk})")
    top = rows[0]
    t = stats["flash_attention"]
    t.update(ms=top[routes[0]], plain_ms=top["plain_ms"],
             library_ms=top["library_ms"], library=top["library"],
             bound_ms=top["bound_ms"], bound_by=top["bound_by"],
             shape=top["shape"])
    t["max_abs_err"] = max(t["max_abs_err"],
                           *(top[r + "_err"] for r in routes))
    return rows


def _scan_inputs(shape, seed, dtype, torch):
    b, s, w = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.rand((b, s, w), generator=g, device=DEV) * 0.499 + 0.5
    x = torch.randn((b, s, w), generator=g, device=DEV)
    h0 = torch.randn((b, w), generator=g, device=DEV)
    return a.to(dtype), x.to(dtype), h0.to(dtype)


def _scan_both(a, x, h0):
    """``rglru_scan`` on both routes: the one S picks through
    ``ops.rglru_scan`` (its route asserted), the other by a raw call of
    its kernel on the same inputs.  Returns {route: h}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rmod
    way = rmod.route(a.shape[1])
    other = "serial" if way == "chunked" else "chunked"
    out = torch.empty_like(a)
    _raw_scan(a, x, h0, out, other)()
    return {way: _routed("rglru_scan", way,
                         lambda: ops.rglru_scan(a, x, h0)), other: out}


def check_rglru():
    """``rglru_scan`` against its plain version on the card, on both
    routes: the reference's shapes, the launcher's ragged shapes and the
    2048-token prompt (a channel at a = 0.9999 throughout), in float32
    and bfloat16; two chunked calls bit-equal; the carried ``h0``.
    Returns its max abs error."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rmod

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = RGLRU_TOL[str(dt).split(".")[-1]]
        for shape in RGLRU_SHAPES + RGLRU_ROWS:
            a, x, h0 = _scan_inputs(shape, sum(shape), dt, torch)
            if shape == RGLRU_TIMED:
                a[:, :, 7] = 0.9999                 # the carry's drift
            want = ref.rglru_scan_ref(a, x, h0)
            got = _scan_both(a, x, h0)
            again = _scan_both(a, x, h0)
            torch.cuda.synchronize()
            errs = []
            for way in ("serial", "chunked"):
                assert got[way].shape == a.shape and got[way].dtype == dt
                errs.append(_attn_close(got[way], want, tol,
                                        f"rglru_scan {way} {dt} {shape}"))
            assert torch.equal(got["chunked"], again["chunked"]), \
                "two chunked calls differ"
            worst = max(worst, *errs)
            print(f"rglru_scan       {str(dt):14s} B,S,W={shape}: max abs "
                  f"err serial {errs[0]:.3e}, chunked {errs[1]:.3e} (tol "
                  f"{tol}; route by S: {rmod.route(shape[1])}); chunked "
                  f"calls bit-equal")
    b, s, w = RGLRU_SHAPES[0]
    h = ops.rglru_scan(torch.full((b, s, w), 0.9, device=DEV),
                       torch.zeros((b, s, w), device=DEV),
                       torch.ones((b, w), device=DEV))
    torch.cuda.synchronize()
    first = float((h[:, 0] - 0.9).abs().max() / 0.9)
    last = float((h[:, -1] - 0.9 ** s).abs().max() / 0.9 ** s)
    assert first <= 1e-5 and last <= 1e-3, (first, last)
    print(f"rglru_scan carries h0: h[:, 0] rel err {first:.3e}, h[:, -1] "
          f"vs 0.9**{s} rel err {last:.3e}")
    return {"rglru_scan": {"max_abs_err": worst}}


def _raw_scan(a, x, h0, out, way):
    """One raw call of the ``way`` scan kernel (no checks, no count; h0
    widened to the float32 the kernel reads, and kept by the call)."""
    import torch

    from repro_torch.kernels import rglru_scan as rmod
    b, s, w = a.shape
    h0 = h0.to(torch.float32).contiguous()
    buf = rmod.scratch(a.device, rmod.scratch_words(b, s, w)) \
        if way == "chunked" else None
    run = _raw_attn(
        rmod, "rglru_scan", "rglru_scan_fwd", rmod._SIG,
        [*a.stride()[:2], *x.stride()[:2], *out.stride()[:2]],
        rmod._DTYPES[a.dtype], a.data_ptr(), x.data_ptr(), h0.data_ptr(),
        out.data_ptr(), b, s, w, int(way == "chunked"),
        buf.data_ptr() if buf is not None else None,
        buf.numel() if buf is not None else 0)
    run.inputs = (h0, buf)
    return run


def time_rglru(stats):
    """Its time at every RGLRU_ROWS shape (float32): the serial and the
    chunked kernel on the same inputs, each rotating over input sets of
    >= ROTATE_BYTES together, beside the byte bound (every kernel time
    must be at or above it) and the plain version; no single PyTorch
    call computes the recurrence.  The 2048-token row fills
    ``stats["rglru_scan"]``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rmod

    name = torch.cuda.get_device_name(0)
    rows = []
    for shape in RGLRU_ROWS:
        b, s, w = shape
        sets = [_scan_inputs(shape, 20 + j, torch.float32, torch)
                for j in range(_sets(3 * b * s * w * 4))]
        a, x, h0 = sets[0]
        want = ref.rglru_scan_ref(a, x, h0)
        row = {"shape": f"B,S,W={shape} f32", "route": rmod.route(s)}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, (3 * a.numel() + h0.numel()) * 4, 2 * a.numel(), "fp32")
        for way in ("chunked", "serial"):
            outs = [torch.empty_like(a) for _ in sets]
            row[way] = _time_rot([_raw_scan(*abh, o, way)
                                  for abh, o in zip(sets, outs)], torch)
            torch.cuda.synchronize()
            row[way + "_err"] = _attn_close(outs[0], want, 1e-4,
                                            f"rglru_scan {way} at {shape}")
            _possible(row[way], row["bound_ms"], f"rglru_scan {way} {shape}")
        row["plain_ms"] = _time_ms(lambda: ref.rglru_scan_ref(a, x, h0),
                                   torch, reps=1, rounds=3)
        rows.append(row)
        print(f"time rglru_scan       {row['shape']}: chunked "
              f"{row['chunked']:.4f} ms (err {row['chunked_err']:.3e}), "
              f"serial {row['serial']:.4f} ms (err {row['serial_err']:.3e}),"
              f" each rotating over {len(sets)} input sets (route by S: "
              f"{row['route']}); plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library none: "
              f"no single PyTorch call")
    top = rows[0]
    t = stats["rglru_scan"]
    t.update(ms=top["chunked"], serial_ms=top["serial"],
             plain_ms=top["plain_ms"], library_ms=None,
             bound_ms=top["bound_ms"], bound_by=top["bound_by"],
             shape=top["shape"])
    t["max_abs_err"] = max(t["max_abs_err"], top["chunked_err"],
                           top["serial_err"])
    return rows


def check_windowed_decode(stats):
    """Windowed decode as the model runs it: ``decode_attention`` over a
    view of the cache rows [off + 1 - window, off] of a [B,T,Hkv,D]
    cache, against the plain windowed prefill attention's last query
    row, at RecurrentGemma's heads (16 over 1 kv head, head_dim 256)."""
    import torch

    from repro_torch.kernels import ops, ref

    b, h, hkv, t, d, window = 2, 16, 1, 64, 256, RG_WINDOW
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        k = _randn((b, t, hkv, d), 30, dt, torch)
        v = _randn((b, t, hkv, d), 31, dt, torch)
        for off in (5, window - 1, window, 40, t - 1):
            q = _randn((b, h, off + 1, d), 32 + off, dt, torch)
            lo = max(0, off + 1 - window)
            got = ops.decode_attention(
                q[:, :, off], k[:, lo:off + 1].transpose(1, 2),
                v[:, lo:off + 1].transpose(1, 2),
                torch.full((b,), off + 1 - lo, dtype=torch.int32,
                           device=DEV))
            want = ref.flash_attention_ref(
                q, k[:, :off + 1].transpose(1, 2),
                v[:, :off + 1].transpose(1, 2), causal=True,
                window=window)[:, :, off]
            torch.cuda.synchronize()
            err = _attn_close(got, want, tol,
                              f"windowed decode {dt} off={off}")
            stats["decode_attention"]["max_abs_err"] = max(
                stats["decode_attention"]["max_abs_err"], err)
            print(f"windowed decode  {str(dt):14s} H,Hkv,D={(h, hkv, d)} "
                  f"window={window} off={off} (rows {lo}..{off}): max abs "
                  f"err {err:.3e} (tol {tol})")


class _Recorder:
    """Wraps the engine's ``prefill`` / ``decode_step`` to count the calls,
    time them (synchronised host clock) and keep their logits."""

    def __init__(self, torch):
        from repro_torch.serving import engine
        self.engine, self.torch = engine, torch
        self.real = (engine.prefill, engine.decode_step)
        self.calls = {"prefill": [], "decode": []}
        self.logits = []

    def _wrap(self, kind, fn):
        def run(*a, **kw):
            sync = self.torch.cuda.synchronize
            sync()
            t0 = time.perf_counter()
            logits, caches = fn(*a, **kw)
            sync()
            self.calls[kind].append(time.perf_counter() - t0)
            self.logits.append(logits.float().cpu())
            return logits, caches
        return run

    def __enter__(self):
        self.engine.prefill = self._wrap("prefill", self.real[0])
        self.engine.decode_step = self._wrap("decode", self.real[1])
        return self

    def __exit__(self, *exc):
        self.engine.prefill, self.engine.decode_step = self.real


def qwen_depth2():
    """Qwen2.5-7B's widths at depth 2, float32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ScanGroup
    full = get_config(ARCH)
    return dataclasses.replace(
        full, n_layers=2,
        groups=(ScanGroup("main", 2, full.groups[0].pattern),),
        param_dtype=torch.float32, compute_dtype=torch.float32)


def recurrentgemma_depth3():
    """RecurrentGemma-9B's widths at depth 3, float32: one (RG-LRU,
    RG-LRU, local attention) superlayer and the tied head, the local
    window cut from 2048 to RG_WINDOW so that a 48-token prompt and 8
    decode steps run windowed prefill and windowed decode."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ScanGroup
    full = get_config(RG_ARCH)
    pattern = tuple(dataclasses.replace(b, window=RG_WINDOW) if b.window
                    else b for b in full.groups[0].pattern)
    return dataclasses.replace(
        full, n_layers=3, groups=(ScanGroup("main", 1, pattern),),
        param_dtype=torch.float32, compute_dtype=torch.float32)


def serve_depth(cfg, prompt_len=48, steps=8, f64=True):
    """A cut-in-depth config at full width in float32: the same weights
    served on the card (kernels) and on the CPU (plain versions) through
    ``ServingEngine``; logits within REL_LOGITS of their max magnitude
    and equal greedy tokens.  With ``f64``, each side's prefill logits
    beside a float64 CPU prefill."""
    import dataclasses

    import torch

    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    materialize, prefill)
    from repro_torch.serving import ServingEngine

    tag = f"depth {cfg.n_layers}"
    t0 = time.perf_counter()
    host = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), "cpu")

    card = _cast(host, DEV)
    print(f"{tag}: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers} float32 weights built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (prompt_len,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    runs = {}
    for dev, params in (("cpu", host), (DEV, card)):
        with _Recorder(torch) as rec:
            eng = ServingEngine(cfg, params, max_batch=1,
                                max_len=prompt_len + steps + 8, device=dev)
            toks = eng.generate(prompt, max_new=steps + 1).tokens
        runs[dev] = (toks, rec.logits)
    (ct, cl), (gt, gl) = runs["cpu"], runs[DEV]
    assert len(cl) == len(gl) == steps + 1
    worst = 0.0
    for a, c in zip(gl, cl):
        assert bool(torch.isfinite(a).all())
        worst = max(worst, float((a - c).abs().max() / c.abs().max()))
    assert worst <= REL_LOGITS, f"{tag} logits differ by {worst:.3e}"
    assert gt == ct, f"tokens differ: card {gt} vs CPU {ct}"
    print(f"{tag}: prefill of {prompt_len} tokens + {steps} decode steps, "
          f"tokens equal {gt}; logits max |card - CPU| / max|CPU| = "
          f"{worst:.3e} (limit {REL_LOGITS})")
    if not f64:
        return
    # which side the gap comes from: the prefill once more on the CPU in
    # float64 (no gate: a measure of float32 rounding through the model)
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    caches = materialize(build_cache_specs(c64, 1, prompt_len + steps + 8,
                                           torch.float64),
                         torch.Generator(), "cpu")
    o64, _ = prefill(_cast(host, torch.float64),
                     {"tokens": torch.tensor([prompt])}, caches, c64)
    o64 = o64.float()
    m = o64.abs().max()
    print(f"{tag}: prefill logits against a float64 CPU run, max |x - "
          f"f64| / max|f64|: card {float((gl[0] - o64).abs().max() / m):.3e}"
          f", CPU float32 {float((cl[0] - o64).abs().max() / m):.3e}")


class _Plain:
    """Swaps the plain version ``ref.<op>_ref`` in for ``ops.<op>``
    (which the model calls) and restores the kernel on exit."""

    def __init__(self, op):
        self.op = op

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.real = ops, getattr(ops, self.op)
        setattr(ops, self.op, getattr(ref, self.op + "_ref"))
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.op, self.real)


def check_bf16_model(cfg, prompt_len=300):
    """A bf16 forward of ``cfg`` (cut in depth, full width) on the card
    with the kernels, then with the plain flash attention swapped in,
    each against a float32 forward of the same weights: the kernel run
    may be no farther from float32 than 2x the plain bf16 run.  The
    prompt is ragged against the 128-row tiles and prefills into a
    longer cache, so the model's cache views reach the sm90 route."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    materialize, prefill)

    c16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    w16 = materialize(build_param_specs(c16),
                      torch.Generator().manual_seed(0), DEV)
    w32 = _cast(w16, torch.float32)                 # the same values
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=torch.Generator().manual_seed(2))

    def forward(c, w):
        caches = materialize(build_cache_specs(c, 1, prompt_len + 16,
                                               c.compute_dtype),
                             torch.Generator(), DEV)
        logits, _ = prefill(w, {"tokens": tokens.to(DEV)}, caches, c)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        return logits.float()

    ops.reset_launches()
    kern = forward(c16, w16)
    routes = ops.route_counts()
    n_attn = ops.launch_counts()["flash_attention"]
    assert n_attn > 0 and routes == {"sm90": n_attn, "simt": 0}, routes
    # a long prompt's scans take the chunked kernel
    n_scan = ops.launch_counts()["rglru_scan"]
    scans = ops.route_counts("rglru_scan")
    assert scans == {"chunked": n_scan, "serial": 0}, scans
    with _Plain("flash_attention"):
        plain = forward(c16, w16)
    f32 = forward(c32, w32)
    m = f32.abs().max()
    d_kern = float((kern - f32).abs().max() / m)
    d_plain = float((plain - f32).abs().max() / m)
    print(f"bf16 {cfg.name} depth {cfg.n_layers}, {prompt_len}-token "
          f"prefill: max |logits - float32| / max|float32| = {d_kern:.3e} "
          f"with the kernels ({n_attn} sm90 flash launches, {n_scan} "
          f"chunked scans), {d_plain:.3e} with the plain flash attention "
          f"(limit 2x)")
    assert d_kern <= 2 * d_plain, (d_kern, d_plain)
    del w16, w32
    torch.cuda.empty_cache()
    return d_kern, d_plain


def check_model_decode(cfg, ctx=2048):
    """One bf16 ``decode_step`` of ``cfg`` (cut in depth, full width) on
    the card at a ``ctx``-row context: its attention layers' decode on
    the split route (counted), each layer's output held against the
    plain version on the model's own q and cache views (2e-2), where a
    wrong combine must fail (``_sees_combine``: the random weights' scores
    spread over hundreds, so each row's softmax sits on its top key and a
    combine that weighs the splits wrongly misses by the values' size);
    then the logits against the same step with the plain
    ``decode_attention`` swapped in, within 2e-2 of their max."""
    import dataclasses
    import math

    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    decode_step, materialize, prefill)

    c16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    w = materialize(build_param_specs(c16),
                    torch.Generator().manual_seed(0), DEV)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, ctx + 1),
                           generator=gen).to(DEV)
    n_attn = per_call_launches(cfg)[1]["decode_attention"]
    caches = materialize(build_cache_specs(c16, 1, ctx + 16, torch.bfloat16),
                         torch.Generator(), DEV)
    _, caches = prefill(w, {"tokens": tokens[:, :ctx]}, caches, c16)

    def step():
        # the step writes its row out of place: both steps see one cache
        ops.reset_launches()
        logits, _ = decode_step(w, tokens[:, ctx:], caches, ctx, c16)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        return logits.float(), ops.route_counts("decode_attention")

    seen, real = [], ops.decode_attention

    def spy(q, k, v, length):
        out = real(q, k, v, length)
        seen.append((q, k, v, length, out))
        return out

    ops.decode_attention = spy
    try:
        kern, routes = step()
    finally:
        ops.decode_attention = real
    assert routes == {"split": n_attn, "single": 0}, routes
    assert len(seen) == n_attn
    tol = ATTN_TOL["bfloat16"]
    op_err, faults, peak = 0.0, {}, 1.0
    for q, k, v, length, out in seen:
        want = ref.decode_attention_ref(q, k, v, length)
        op_err = max(op_err, _attn_close(out, want, tol,
                                         "model decode views"))
        for name, e in _sees_combine(q, k, v, length, want, tol,
                                     "model decode views").items():
            faults[name] = min(faults.get(name, math.inf), e)
        g = q.shape[1] // k.shape[1]
        p = torch.softmax(torch.einsum(
            "bhd,bhtd->bht", q.float(), k.repeat_interleave(g, 1).float())
            / math.sqrt(q.shape[-1]), -1)
        peak = min(peak, float(p.amax(-1).mean()))
    del seen
    with _Plain("decode_attention"):
        plain, _ = step()
    d_both = float((kern - plain).abs().max() / plain.abs().max())
    print(f"bf16 {cfg.name} depth {cfg.n_layers}, decode_step at a "
          f"{ctx}-row context ({n_attn} split-route decodes; each row's "
          f"largest softmax weight {peak:.4f} on average, least over the "
          f"layers): each layer's decode against the plain version on "
          f"the model's views max abs err {op_err:.3e} (tol {tol}), a "
          f"wrong combine rejected in every layer (least max abs err: "
          + ", ".join(f"{n} {e:.3e}" for n, e in faults.items()) +
          f"); logits against the plain decode_attention's step: max "
          f"|kernel - plain| / max|plain| = {d_both:.3e} (limit {tol})")
    assert d_both <= tol, d_both
    del w, caches
    torch.cuda.empty_cache()
    return d_both


def _cast(tree, to):
    """Every leaf of a parameter tree moved to a device or dtype."""
    if isinstance(tree, dict):
        return {k: _cast(v, to) for k, v in tree.items()}
    return tree.to(to)


def _serve_lines(argv, **kw):
    import contextlib
    import io

    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(argv, **kw) == 0
    out = buf.getvalue().splitlines()
    for line in out:
        print(f"  {line}")
    return out


def profile_serving(arch, requests=3):
    """Where the time of a served request goes at full width: the card's
    kernel time by name over a few requests (``torch.profiler``, after a
    warm-up request), against the host clock of the same requests run
    without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import RunFlags, build_param_specs, materialize
    from repro_torch.serving import ServingEngine

    cfg = get_config(arch)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=48,
                        flags=RunFlags(remat="none"), device=DEV)

    def serve():
        for _ in range(requests):
            eng.generate([1, 2, 3], max_new=4)
        torch.cuda.synchronize()

    serve()                                           # warm-up
    t0 = time.perf_counter()
    serve()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve()
    # device-side events only (kernels, copies): an operator's own device
    # time repeats that of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    if not busy:
        print("profile: the profiler recorded no device time; the idle "
              "share is not measured")
        return
    print(f"profile {arch}: {requests} requests (4 forwards each) took "
          f"{1e3 * wall:.3f} ms of host clock without the profiler; the "
          f"card's kernels took {busy:.3f} ms under it, so the card was "
          f"idle {100 * (1 - busy / (1e3 * wall)):.1f} % of the request time")
    for key, ms, n in rows[:10]:
        print(f"  device {ms:10.3f} ms  {100 * ms / busy:5.1f} %  x{n:<6d} "
              f"{key[:90]}")
    del params, eng
    torch.cuda.empty_cache()


def per_call_launches(cfg):
    """The kernel launches one prefill and one decode step of ``cfg``
    make: each attention layer launches ``flash_attention`` (prefill) or
    ``decode_attention`` (decode), each RG-LRU layer ``rglru_scan``."""
    from repro_torch.models import Mixer
    mixers = [blk.mixer for g in cfg.groups for _ in range(g.repeats)
              for blk in g.pattern]
    n_attn, n_rec = mixers.count(Mixer.ATTN), mixers.count(Mixer.RGLRU)
    assert n_attn + n_rec == cfg.n_layers, mixers
    return ({"flash_attention": n_attn, "rglru_scan": n_rec},
            {"decode_attention": n_attn, "rglru_scan": n_rec})


def serve_launcher(arch, argv=None, cfg=None):
    """The launcher at full width and depth on the card, counted and
    timed, then its --reduced run on the CPU: the energy lines must be
    equal (the clock and the loader come from the full config's
    checkpoint bytes, not from compute).  Every kernel's launches must
    equal what the recorded prefills and decode steps of ``cfg`` (the
    full config by default) make, and no other kernel may launch.
    Returns the launch counts (one an op call) and the number of
    ``decode_attention``'s combine launches (one a split-route call)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    argv = list(argv or ("--arch", arch, "--hours", "6"))
    per_prefill, per_decode = per_call_launches(cfg or get_config(arch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _Recorder(torch) as rec:
        card = _serve_lines(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.route_counts()
    decodes = ops.route_counts("decode_attention")
    scans = ops.route_counts("rglru_scan")
    pre, dec = rec.calls["prefill"], rec.calls["decode"]
    print(f"launcher {arch} on the card: wall {wall:.3f} s, {len(pre)} "
          f"prefills (mean {1e3 * statistics.mean(pre):.6f} ms, median "
          f"{1e3 * statistics.median(pre):.6f} ms), {len(dec)} decode "
          f"steps (mean {1e3 * statistics.mean(dec):.6f} ms, median "
          f"{1e3 * statistics.median(dec):.6f} ms), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    print(f"launcher {arch} launches {counts}; flash_attention routes "
          f"{routes}, decode_attention routes {decodes}, rglru_scan routes "
          f"{scans}")
    want = {k: per_prefill.get(k, 0) * len(pre) +
            per_decode.get(k, 0) * len(dec) for k in counts}
    assert counts == want, (counts, want)
    # the launchers serve bf16 at head dims the sm90 route takes; their
    # 48-row caches are one split, their 3- and 1-step scans serial
    assert routes == {"sm90": counts["flash_attention"], "simt": 0}, routes
    assert decodes == {"split": 0,
                       "single": counts["decode_attention"]}, decodes
    assert scans == {"chunked": 0, "serial": counts["rglru_scan"]}, scans
    cpu = _serve_lines(argv + ["--reduced"], device="cpu")
    assert card[1] == cpu[1], (card[1], cpu[1])
    print(f"launcher {arch}: energy line equal to the --reduced run on the "
          f"CPU; launches exactly {per_prefill} per prefill and "
          f"{per_decode} per decode step")
    # a split-route decode launches the combine kernel too
    return counts, decodes["split"]


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
    import torch

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

    real_oss = ops.ordered_segment_sum

    def seen_ordered_segment_sum(vals, keys, num):
        shapes.setdefault("longest_run", int(
            torch.bincount(keys, minlength=num).max()) if keys.numel()
            else 0)
        return real_oss(vals, keys, num)

    torchback.ops.fused_meter = seen_fused_meter    # records shapes only
    torchback.ops.ordered_segment_sum = seen_ordered_segment_sum
    try:
        torchback.FUSED = True
        day = flash_crowd(n_routes=600, fleet="200xh100+200xa100+200xl40s",
                          seed=100, base_rate_hr=130.0, spike_x=60.0)
        main = _drive(lambda: day.to_scenario(Breakeven, carbon_trace=ct),
                      "acceptance day (fused)", compute_bound=False)
        print(f"acceptance day fused_meter N, [G, K] = "
              f"{shapes['fused_meter']}; ordered_segment_sum's longest "
              f"run {shapes['longest_run']}")
        main["longest_run"] = shapes["longest_run"]
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
        torchback.ops.ordered_segment_sum = real_oss
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
    # float32 products on the card stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    hgmma = count_hgmma()
    stats = check_kernels()
    main_counts, unfused_counts = drive_days()
    if "--metering" in sys.argv[1:]:        # phases 1-4 alone
        print(json.dumps({k: {x: y for x, y in v.items()}
                          for k, v in stats.items()}))
        return 0
    attn = check_attention()
    check_flash_sm90(attn)
    check_decode_split(attn)
    decode_rows = time_attention(attn)
    flash_rows = time_flash(attn)
    serve_depth(qwen_depth2())
    check_bf16_model(qwen_depth2())
    check_model_decode(qwen_depth2())
    qwen_counts, qwen_combines = serve_launcher(ARCH)
    profile_serving(ARCH)
    torch.cuda.empty_cache()                   # the Qwen weights are gone
    stats.update(attn)
    stats.update(check_rglru())
    scan_rows = time_rglru(stats)
    check_windowed_decode(stats)
    serve_depth(recurrentgemma_depth3(), f64=False)
    check_bf16_model(recurrentgemma_depth3())
    rg_counts, rg_combines = serve_launcher(RG_ARCH)
    profile_serving(RG_ARCH)
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"fused_meter": csrc + "segment_trapz.cu",
              "segment_trapz": csrc + "segment_trapz.cu",
              "ordered_segment_sum": csrc + "segment_trapz.cu",
              "flash_attention": csrc + "flash_attention_sm90.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "rglru_scan": csrc + "rglru_scan.cu"}
    replaces = {
        "fused_meter": "src/repro/kernels/segment_trapz.py:114",
        "segment_trapz": "src/repro/kernels/segment_trapz.py:161",
        # not a Pallas kernel: the jax.ops.segment_sum it replaces
        "ordered_segment_sum": "src/repro/fleet/mega/jaxback.py:236",
        "flash_attention": "src/repro/kernels/flash_attention.py:78",
        "decode_attention": "src/repro/kernels/decode_attention.py:57",
        "rglru_scan": "src/repro/kernels/rglru_scan.py:40",
    }
    # each path's own run: the fleet days for the metering kernels, the
    # two launchers (summed) for the attention kernels
    launches = {"fused_meter": main_counts["fused_meter"],
                "segment_trapz": unfused_counts["segment_trapz"],
                "ordered_segment_sum": main_counts["ordered_segment_sum"],
                "flash_attention": qwen_counts["flash_attention"] +
                rg_counts["flash_attention"],
                "decode_attention": qwen_counts["decode_attention"] +
                rg_counts["decode_attention"],
                "rglru_scan": rg_counts["rglru_scan"]}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
               for k, v in stats.items()]
    for row in kernels:
        if "library" in stats[row["name"]]:
            row["library"] = stats[row["name"]]["library"]
        if row["name"] in ("fused_meter", "segment_trapz",
                           "ordered_segment_sum"):
            row.update({k: stats[row["name"]][k] for k in (
                "sets", "fp64_per_entry", "longest_run", "dadd_ns")
                if k in stats[row["name"]]})
            if row["name"] == "ordered_segment_sum":
                row["acceptance_longest_run"] = main_counts["longest_run"]
        if row["name"] == "flash_attention":
            # every launcher launch took the sm90 route (serve_launcher);
            # the simt kernel (float32, other head dims) timed beside it
            row.update(kernel_route="sm90", hgmma=hgmma,
                       simt_source=csrc + "flash_attention.cu",
                       simt_ms=flash_rows[0]["simt"],
                       rows={r["label"]: {k: r[k] for k in (
                           "sm90", "simt", "plain_ms", "library_ms",
                           "library", "bound_ms")} for r in flash_rows})
        if row["name"] == "decode_attention":
            # the split route's time; the single route (one block a
            # (b, kv head, head group)) and the back-to-back time of one
            # input set beside it; every launcher decode took single.
            # ``launches`` counts op calls; a split-route call launches
            # the combine kernel too, counted in ``combine_launches``
            row.update(kernel_route="split",
                       combine_launches=qwen_combines + rg_combines,
                       splits=stats["decode_attention"]["splits"],
                       single_ms=stats["decode_attention"]["single_ms"],
                       l2_ms=stats["decode_attention"]["l2_ms"],
                       rows={r["label"]: {k: r.get(k) for k in (
                           "split", "single", "l2_ms", "splits",
                           "plain_ms", "library_ms", "library",
                           "bound_ms")} for r in decode_rows})
        if row["name"] == "rglru_scan":
            # the chunked route's time, the serial one's beside it; every
            # launcher scan took serial
            row.update(kernel_route="chunked",
                       serial_ms=stats["rglru_scan"]["serial_ms"],
                       rows={r["shape"]: {k: r[k] for k in (
                           "chunked", "serial", "plain_ms", "bound_ms")}
                           for r in scan_rows})
    for row in kernels:
        _possible(row["ms"], row["bound_ms"], row["name"])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
