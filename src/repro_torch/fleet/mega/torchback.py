"""PyTorch + CUDA bulk-scan backend for the mega-simulator
(``run_mega(..., backend="torch")``).

``megasim.run_mega`` splits into a STRUCTURAL event loop (heap events:
load completions, armed evictions -- inherently sequential, stays
Python) and BULK phases that touch every request or metered segment.
This module retires the bulk phases on the GPU behind the
``_NumpyBulk`` seam:

  * **big-gap scans** -- ``prepare`` stacks streams into padded
    matrices (one per power-of-two length bucket, so a short stream
    never pads to the longest) and one reversed ``cummin`` yields a
    ``nextbig`` table per (stream, T): the run ending at pointer ``p``
    is the O(1) lookup ``nextbig[p]``.  Tables are computed on the
    device and copied to the host once per bucket -- the event loop
    reads them per event, which must not touch the device.
  * **lazy-commit billing** -- waiter slices absorbed into mid-load
    replicas are recorded as (stream, lo, hi, drain-time) references;
    ``finalize`` expands every record in one ragged gather
    (``searchsorted`` over the record-start prefix sums) and the wait
    of each request is one vectorized subtract.
  * **energy accounting** -- each power-state transition appends
    ``(device*3 + state, dt, watts)``; per-(device, state) joules and
    seconds are summed per key IN LOG ORDER (``ops.ordered_segment_sum``)
    so they are bit-equal to the numpy backend's running sums, which
    the 0.0-USD cost anchor rests on.
  * **carbon integration** -- by default one fused CUDA kernel
    (``ops.fused_meter``) meters the raw charge log: joules, seconds,
    carbon increments and start prefixes for every zone's trace in one
    launch.  With ``REPRO_MEGA_FUSED=0`` the coalesced power segments
    go through the ``ops.segment_trapz`` kernel once per zone trace.
    Per-device carbon, the hourly timeline and per-tier billed seconds
    are plain PyTorch reductions of the kernel outputs.

Everything is float64 on the device (Hopper has native FP64).  Both
backends drive the identical event loop and see identical calls, so
requests/cold starts are equal, per-(device, state) energy is
bit-equal, and carbon totals agree to <=1e-9 relative -- pinned in
``tests/test_torch_mega.py``.  Every reduction is deterministic, so a
day replays to the same bits.

``sweep_traces`` / ``run_mega_sweep`` run batches of production-shaped
days: each route's thinned-Poisson arrivals are sampled on the device
from its own generator, then every point replays through
``run_mega(backend="torch")`` (``tests/test_torch_sweep.py``).
"""
from __future__ import annotations

import array
import itertools
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fleet.carbon import CarbonTrace
from repro_torch.fleet.fleetsim import DAY, FleetResult
from repro_torch.fleet.mega import megasim
from repro_torch.fleet.mega.traces import FleetTrace, RouteTrace, _route_plan
from repro_torch.kernels import ops, ref

_J_PER_KWH = 3.6e6

# Fused metering (kernels/ops.fused_meter): energy segment-sums, carbon
# integrals, and per-tier billed seconds in ONE pass over the charge
# log instead of three.  Module-level so tests can monkeypatch it; each
# _TorchBulk snapshots the flag at construction.
FUSED = os.environ.get("REPRO_MEGA_FUSED", "1") != "0"


def resolve_device(device: Optional[str]) -> torch.device:
    """The device the bulk phases run on: ``None`` means the GPU.  A GPU
    request without CUDA raises -- the backend never quietly carries on
    on the CPU (pass ``device="cpu"`` for the plain PyTorch versions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_mega(backend='torch') runs its bulk phases on a CUDA "
            "device and none is available; pass device='cpu' to run the "
            "plain PyTorch versions, or use backend='numpy'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def _pow2(n: int, lo: int = 256) -> int:
    """Smallest power of two >= max(n, 1), floored at ``lo``: the length
    bucket of a stream in the big-gap scan."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


# ---------------------------------------------------------------------------
# Bulk programs (device tensors in, device tensors out).
# ---------------------------------------------------------------------------

def _nextbig_rows(mat: torch.Tensor, Ts: torch.Tensor) -> torch.Tensor:
    """Per-row ``nextbig`` tables: ``out[r, p]`` = the smallest i >= p
    with ``mat[r, i+1] - mat[r, i] > Ts[r]``, or the sentinel L-1 when
    no such gap remains.  Rows are arrival streams padded by repeating
    their last arrival (gap 0: never "big"), so padding cannot end a
    run early."""
    gaps = mat[:, 1:] - mat[:, :-1]
    L1 = gaps.shape[1]
    idx = torch.where(gaps > Ts[:, None],
                      torch.arange(L1, dtype=torch.int64,
                                   device=mat.device)[None, :],
                      torch.tensor(L1, dtype=torch.int64, device=mat.device))
    return torch.cummin(idx.flip(1), dim=1).values.flip(1)


def _bill_gather(flat: torch.Tensor, off: torch.Tensor, sid: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor,
                 total: int) -> torch.Tensor:
    """Expand ragged billing records into per-request waits.

    Record r says: arrivals ``arr_sid[lo:hi]`` of stream ``sid`` were
    served at drain time ``t`` (their wait is ``t - arrival``).  Output
    slot k belongs to the record whose cumulative-count prefix contains
    k (``searchsorted`` with right=True steps over zero-length
    records), and its arrival index is the offset within that record.
    """
    cnt = hi - lo
    starts = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(total, dtype=torch.int64, device=flat.device)
    r = torch.searchsorted(starts, k, right=True) - 1
    r = torch.clamp(r, 0, sid.shape[0] - 1)
    pos = off[sid[r]] + lo[r] + (k - starts[r])
    pos = torch.clamp(pos, 0, flat.shape[0] - 1)
    return t[r] - flat[pos]


def _energy_segsum(keys: torch.Tensor, dt: torch.Tensor, pw: torch.Tensor,
                   num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(device, state) joules and seconds from the transition log
    (keys = device*3 + state), each key's entries summed in log order."""
    out = ops.ordered_segment_sum(torch.stack([dt * pw, dt]), keys, num)
    return out[0], out[1]


def _segsum(x: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """Per-key sums of ``x``, the same bits on every run: ``index_put_``
    with ``accumulate=True`` adds each key's entries in a fixed order
    (``index_add_`` on the GPU adds with atomics in whatever order the
    threads land, so two replays of one day could differ in the last
    bit)."""
    return torch.zeros(num, dtype=x.dtype, device=x.device) \
        .index_put_((idx,), x, accumulate=True)


def _carbon_fused(a, b, w, dev, bucket, pseg, pk, pw, kt, kv, cum, tbr, *,
                  period: float, n_dev: int, nb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kgCO2e per device AND the cumulative hourly timeline in one pass.

    Per device: the segment_trapz kernel over every metered power
    segment, attributed by one segment-sum.

    Timeline: the cumulative emission at boundary t is
    ``sum_i w_i * (F(min(b_i, t)) - F(min(a_i, t)))``.  Segments ENDING
    at or before t contribute their whole (already-computed) integral
    -- a segment-sum into the bin of ``b`` plus a cumsum over bins --
    and only segments STRADDLING t (``a < t < b``; at most one per
    device per boundary, precomputed host-side as (pseg, pk) pairs)
    need a partial ``w * (F(t) - F(a))``."""
    per_seg = ops.segment_trapz(a, b, w, kt, kv, cum, period=period)
    per_dev = _segsum(per_seg, dev, n_dev) / _J_PER_KWH
    full = torch.cumsum(_segsum(per_seg, bucket, nb), 0)
    if nb > 1 and pseg.numel():
        F_t = ref.prefix_integral(tbr, kt, kv, cum, period)
        F_a = ref.prefix_integral(a[pseg], kt, kv, cum, period)
        corr = _segsum(pw * (F_t[pk] - F_a), pk, nb - 1)
        full[:nb - 1] += corr
    return per_dev, full / _J_PER_KWH


def _meter_fused(keys, a, b, dt, pw, g, bucket, tdev, pseg, pk, pwp,
                 kts, kvs, cums, pers, tbr, *,
                 n_dev: int, nb: int, n_tier: int):
    """The whole metering reduction fed by ONE fused kernel pass
    (``ops.fused_meter``) over the raw charge log:

      * per-(device, state) joules/seconds -- the kernel's ``w * dt``
        and ``dt`` lanes summed per key in log order, bit-identical to
        the unfused path and to the numpy backend;
      * per-device carbon + the hourly cumulative timeline -- the
        end-bin + straddle-correction decomposition of
        ``_carbon_fused``, over raw log entries and with every zone's
        trace in one stacked-table launch;
      * per-tier billed seconds -- the per-(device, state) seconds
        summed by their device's tier (in mega scope every metered
        state is powered-on, so raw seconds == billed seconds): 3 x
        n_dev values, not one run of the whole log per tier.
    """
    e, s, c, fa = ops.fused_meter(a, b, dt, pw, g, kts, kvs, cums, pers)
    es = ops.ordered_segment_sum(torch.stack([e, s]), keys, n_dev * 3)
    dev = keys // 3
    per_dev = _segsum(c, dev, n_dev) / _J_PER_KWH
    tier_s = _segsum(es[1], tdev.repeat_interleave(3), n_tier)
    full = torch.cumsum(_segsum(c, bucket, nb), 0)
    if nb > 1 and pseg.numel():
        Fb = ref.prefix_integral(                          # [G, nb-1]
            tbr[None, :].expand(kts.shape[0], -1).contiguous(), kts, kvs,
            cums, pers[:, None])
        corr = _segsum(pwp * (Fb[g[pseg].long(), pk] - fa[pseg]), pk,
                       nb - 1)
        full[:nb - 1] += corr
    return es[0], es[1], per_dev, tier_s, full / _J_PER_KWH


def _straddles(a: np.ndarray, b: np.ndarray, w: np.ndarray,
               tbr: np.ndarray):
    """Host-side bin geometry: each segment's full integral lands in the
    bin of its END (``bucket``), and the (segment, boundary) STRADDLE
    pairs -- bounded by devices x boundaries, since a device's segments
    are disjoint in time -- are expanded with one repeat/cumsum."""
    k_lo = np.searchsorted(tbr, a, side="right")
    bucket = np.searchsorted(tbr, b, side="left")
    cnt = np.maximum(bucket - k_lo, 0)
    total = int(cnt.sum())
    ps = np.repeat(np.arange(a.size, dtype=np.int64), cnt)
    starts = np.cumsum(cnt) - cnt
    pk = np.arange(total, dtype=np.int64) - starts[ps] + k_lo[ps]
    return bucket, ps, pk, w[ps]


def _bins(horizon: float, last_end: float):
    """The hourly timeline's bins: they cover max(horizon, last segment
    end), the last bin absorbing any overshoot."""
    bin_s = 3600.0
    end = max(horizon, last_end)
    nb = max(int(math.ceil(end / bin_s - 1e-12)), 1)
    return bin_s, end, nb, bin_s * np.arange(1, nb)


# ---------------------------------------------------------------------------
# The backend object megasim drives.
# ---------------------------------------------------------------------------

class _TorchBulk:
    """Drop-in for ``megasim._NumpyBulk`` that records the bulk work
    during the event loop and retires it on the device at finalize.
    See the module docstring for the four phases; ``self.t`` carries
    the same phase-timing keys the numpy backend reports.  Device
    phases synchronise before their clock is read, so the timings
    cover the device work and not only its launch."""

    name = "torch"
    wants_tables = True

    def __init__(self, n_dev: int, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.n_dev = n_dev
        self.t = {"biggap_s": 0.0, "billing_s": 0.0, "energy_s": 0.0,
                  "carbon_s": 0.0}
        # transition log (energy) and billing records, appended by the
        # event loop, reduced at finalize (array.array: appends like a
        # list, converts to ndarray as a buffer view)
        self._ekey = array.array("i")
        self._edt = array.array("d")
        self._epw = array.array("d")
        # absolute segment bounds, only consumed by the fused pass
        # (the unfused carbon path reads the coalesced `segs` lists)
        self._ea = array.array("d")
        self._eb = array.array("d")
        self.fused = FUSED
        self._bill: List[Tuple[int, int, int, float]] = []
        self._scalar_waits: List[float] = []
        self._sid: Dict[str, int] = {}
        self._flat = np.empty(0, dtype=np.float64)
        self._off = np.empty(0, dtype=np.int64)
        self._nextbig: Dict[Tuple[str, float], np.ndarray] = {}

    # Results go back to megasim as Python floats (``tolist``), never
    # numpy scalars: the builtin ``sum`` that folds per-state Wh into a
    # device total compensates only for exact floats, so numpy scalars
    # would round the fleet total differently from the numpy backend.

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a numpy array."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- prepare: stacked stream matrices + nextbig tables -------------------
    def prepare(self, streams: Dict[str, "megasim._Stream"],
                stream_Ts: Dict[str, Sequence[float]]) -> None:
        t0 = time.perf_counter()
        mids = list(streams)
        self._sid = {mid: i for i, mid in enumerate(mids)}
        arrs = [streams[mid].arr for mid in mids]
        lens = np.array([a.size for a in arrs], dtype=np.int64)
        off = np.zeros(len(arrs) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        self._off = off[:-1]
        self._flat = (np.concatenate(arrs) if arrs
                      else np.empty(0, dtype=np.float64))
        # one nextbig row per (stream, candidate timeout), bucketed by
        # padded length; computed rows are parked in the stream's shared
        # biggap dict (under ("nb", T) keys the numpy float-keyed
        # lookups never see) so repeat runs on the same FleetTrace skip
        # the scan entirely
        buckets: Dict[int, List[Tuple[str, float, np.ndarray]]] = {}
        for mid in mids:
            ms = streams[mid]
            if ms.n < 2:
                continue
            for T in dict.fromkeys(stream_Ts.get(mid, ())):
                if math.isinf(T) or (mid, T) in self._nextbig:
                    continue
                row = ms.biggap.get(("nb", T))
                if row is not None:
                    self._nextbig[(mid, T)] = row
                    continue
                L = _pow2(ms.n)
                buckets.setdefault(L, []).append((mid, float(T), ms.arr))
        for L, grp in buckets.items():
            mat = np.zeros((len(grp), L), dtype=np.float64)
            Ts = np.full(len(grp), np.inf)
            for r, (_mid, T, arr) in enumerate(grp):
                mat[r, :arr.size] = arr
                mat[r, arr.size:] = arr[-1]
                Ts[r] = T
            nb = _nextbig_rows(self._dev(mat), self._dev(Ts)).cpu().numpy()
            for r, (mid, T, _arr) in enumerate(grp):
                self._nextbig[(mid, T)] = nb[r]
                ms = streams[mid]
                if len(ms.biggap) >= megasim.biggap_cache.max_timeouts:
                    ms.biggap.pop(next(iter(ms.biggap)))
                ms.biggap[("nb", T)] = nb[r]
        self.t["biggap_s"] += time.perf_counter() - t0

    # -- event-loop hooks ----------------------------------------------------
    def charge(self, d: int, s: int, dt: float, p: float,
               a: float = 0.0, b: float = 0.0) -> None:
        self._ekey.append(d * 3 + s)
        self._edt.append(dt)
        self._epw.append(p)
        self._ea.append(a)
        self._eb.append(b)

    def last_of_run(self, ms, T: float) -> int:
        t0 = time.perf_counter()
        if ms.ptr >= ms.n - 1:
            last = ms.n - 1
        else:
            row = self._nextbig.get((ms.mid, T))
            if row is None:
                # timeout the eager probe skipped (or an infinite one):
                # the numpy scan path is the fallback, same answer
                big = ms.biggaps(T)
                j = int(np.searchsorted(big, ms.ptr))
                last = int(big[j]) if j < big.size else ms.n - 1
            else:
                v = int(row[ms.ptr])
                last = v if v <= ms.n - 2 else ms.n - 1
        self.t["biggap_s"] += time.perf_counter() - t0
        return last

    def absorb(self, ms, d: int, lo: int, hi: int, t_done: float) -> None:
        ent = ms.waiters.get(d)
        if ent is None:
            ent = ms.waiters[d] = [0, []]
        ent[0] += hi - lo
        ent[1].append((lo, hi))

    def wait_one(self, ms, d: int, t: float) -> None:
        ent = ms.waiters.get(d)
        if ent is None:
            ent = ms.waiters[d] = [0, []]
        ent[0] += 1
        ent[1].append(t)

    def waiter_count(self, ms, d: int) -> int:
        ent = ms.waiters.get(d)
        return ent[0] if ent is not None else 0

    def drain(self, ms, d: int, t: float) -> int:
        ent = ms.waiters.pop(d, None)
        if ent is None:
            return 0
        sid = self._sid[ms.mid]
        for item in ent[1]:
            if type(item) is tuple:
                self._bill.append((sid, item[0], item[1], t))
            else:
                self._scalar_waits.append(t - item)
        return ent[0]

    # -- finalize: the bulk reductions on the device -------------------------
    def finalize(self, segs, fleet_segments, trace: CarbonTrace,
                 horizon: float, dev_traces=None,
                 tiers=None) -> "megasim._Fin":
        if self.fused:
            (energy_j, dur_s, carbon_dev, timeline,
             tier_billed) = self._finalize_fused(trace, horizon,
                                                 dev_traces, tiers)
            waits = self._finalize_billing()
        else:
            energy_j, dur_s = self._finalize_energy()
            waits = self._finalize_billing()
            carbon_dev, timeline = self._finalize_carbon(
                segs, fleet_segments, trace, horizon, dev_traces)
            tier_billed = None
        self.t["bulk_scan_s"] = sum(self.t.values())
        return megasim._Fin(energy_j, dur_s, waits, carbon_dev, timeline,
                            dict(self.t), tier_billed)

    def _finalize_energy(self):
        t0 = time.perf_counter()
        ej, ds = _energy_segsum(
            self._dev(np.asarray(self._ekey, dtype=np.int64)),
            self._dev(np.asarray(self._edt, dtype=np.float64)),
            self._dev(np.asarray(self._epw, dtype=np.float64)),
            self.n_dev * 3)
        energy_j = ej.reshape(self.n_dev, 3).tolist()
        dur_s = ds.reshape(self.n_dev, 3).tolist()
        self._sync()
        self.t["energy_s"] += time.perf_counter() - t0
        return energy_j, dur_s

    def _finalize_billing(self) -> np.ndarray:
        t0 = time.perf_counter()
        scalar = np.asarray(self._scalar_waits, dtype=np.float64)
        if not self._bill:
            self.t["billing_s"] += time.perf_counter() - t0
            return scalar
        rec = np.asarray(self._bill, dtype=np.float64)
        sid = rec[:, 0].astype(np.int64)
        lo = rec[:, 1].astype(np.int64)
        hi = rec[:, 2].astype(np.int64)
        total = int((hi - lo).sum())
        w = _bill_gather(self._dev(self._flat), self._dev(self._off),
                         self._dev(sid), self._dev(lo), self._dev(hi),
                         self._dev(rec[:, 3]), total)
        waits = np.concatenate([w.cpu().numpy(), scalar])
        self._sync()
        self.t["billing_s"] += time.perf_counter() - t0
        return waits

    def _finalize_carbon(self, segs, fleet_segments, trace: CarbonTrace,
                         horizon: float, dev_traces=None):
        t0 = time.perf_counter()
        if len(fleet_segments) == 0:
            self.t["carbon_s"] += time.perf_counter() - t0
            return [0.0] * self.n_dev, []
        # bin geometry is GLOBAL (all zones share the sim clock) even
        # when devices integrate against different traces
        bin_s, end, nb, tbr = _bins(horizon,
                                    max(s[-1][1] for s in segs if s))
        # partition devices by their zone's trace object: one kernel
        # launch per distinct trace, device ids group-local, timelines
        # summed elementwise
        if dev_traces is None or all(tr is trace for tr in dev_traces):
            groups = [(trace, list(range(self.n_dev)))]
        else:
            by_trace: Dict[int, Tuple[CarbonTrace, List[int]]] = {}
            for d, tr in enumerate(dev_traces):
                by_trace.setdefault(id(tr), (tr, []))[1].append(d)
            groups = list(by_trace.values())
        per_dev_out = np.zeros(self.n_dev, dtype=np.float64)
        cums_total = np.zeros(nb, dtype=np.float64)
        tbr_d = self._dev(tbr)
        for gtrace, gdevs in groups:
            gsegs = [segs[d] for d in gdevs]
            gn = sum(len(s) for s in gsegs)
            if gn == 0:
                continue
            seg = np.fromiter(
                itertools.chain.from_iterable(
                    itertools.chain.from_iterable(gsegs)),
                dtype=np.float64, count=3 * gn).reshape(gn, 3)
            a_np, b_np, w_np = (np.ascontiguousarray(seg[:, i])
                                for i in range(3))
            dev = np.repeat(np.arange(len(gdevs), dtype=np.int64),
                            [len(s) for s in gsegs])
            bucket, pseg, pk, pw = _straddles(a_np, b_np, w_np, tbr)
            per_dev, cums = _carbon_fused(
                self._dev(a_np), self._dev(b_np), self._dev(w_np),
                self._dev(dev), self._dev(bucket), self._dev(pseg),
                self._dev(pk), self._dev(pw),
                self._dev(np.asarray(gtrace._kt, dtype=np.float64)),
                self._dev(np.asarray(gtrace._kv, dtype=np.float64)),
                self._dev(np.asarray(gtrace._cum, dtype=np.float64)),
                tbr_d, period=float(gtrace.period_s), n_dev=len(gdevs),
                nb=nb)
            per_dev_out[gdevs] = per_dev.cpu().numpy()
            cums_total += cums.cpu().numpy()
        timeline = [(min((j + 1) * bin_s, end), float(cums_total[j]))
                    for j in range(nb)]
        self._sync()
        self.t["carbon_s"] += time.perf_counter() - t0
        return per_dev_out.tolist(), timeline

    def _finalize_fused(self, trace: CarbonTrace, horizon: float,
                        dev_traces=None, tiers=None):
        """Energy, durations, carbon, timeline, and per-tier billed
        seconds from ONE ``fused_meter`` launch over the raw charge
        log.  Host-side prep (table stacking, bin/straddle geometry) is
        booked under ``carbon_s`` and the device work under
        ``energy_s``, the keys the numpy backend reports."""
        t0 = time.perf_counter()
        n = len(self._ekey)
        tier_names = sorted(set(tiers)) if tiers else ["on_demand"]
        if n == 0:
            z = [[0.0, 0.0, 0.0] for _ in range(self.n_dev)]
            self.t["energy_s"] += time.perf_counter() - t0
            return (z, [r[:] for r in z], [0.0] * self.n_dev, [],
                    {t: 0.0 for t in tier_names})
        keys_np = np.asarray(self._ekey, dtype=np.int64)
        a_np = np.asarray(self._ea, dtype=np.float64)
        b_np = np.asarray(self._eb, dtype=np.float64)
        dt_np = np.asarray(self._edt, dtype=np.float64)
        pw_np = np.asarray(self._epw, dtype=np.float64)
        # stacked knot tables: one row per distinct zone trace, K
        # padded by repeating the final knot (in-period offsets are
        # strictly below the period, so pad knots never match)
        if dev_traces is None:
            dev_traces = [trace] * self.n_dev
        gid: Dict[int, int] = {}
        gidx_dev = np.zeros(self.n_dev, dtype=np.int32)
        tabs: List[CarbonTrace] = []
        for d, tr in enumerate(dev_traces):
            gi = gid.get(id(tr))
            if gi is None:
                gi = gid[id(tr)] = len(tabs)
                tabs.append(tr)
            gidx_dev[d] = gi
        kmax = max(len(t._kt) for t in tabs)
        kts = np.zeros((len(tabs), kmax), dtype=np.float64)
        kvs = np.zeros((len(tabs), kmax), dtype=np.float64)
        cums = np.zeros((len(tabs), kmax), dtype=np.float64)
        pers = np.array([float(t.period_s) for t in tabs])
        for gi, tr in enumerate(tabs):
            for dst, src in ((kts, tr._kt), (kvs, tr._kv),
                             (cums, tr._cum)):
                row = np.asarray(src, dtype=np.float64)
                dst[gi, :row.size] = row
                dst[gi, row.size:] = row[-1]
        g_np = gidx_dev[keys_np // 3]
        # hourly-bin geometry + straddle pairs, exactly the unfused
        # decomposition (_finalize_carbon) but over raw log entries
        bin_s, end, nb, tbr = _bins(horizon, float(b_np.max()))
        bucket, pseg, pk, pwp = _straddles(a_np, b_np, pw_np, tbr)
        tdev = np.array([tier_names.index(t) for t in tiers],
                        dtype=np.int64) if tiers else \
            np.zeros(self.n_dev, dtype=np.int64)
        self.t["carbon_s"] += time.perf_counter() - t0
        t1 = time.perf_counter()
        ej, ds, per_dev, tier_s, cums_nb = _meter_fused(
            self._dev(keys_np), self._dev(a_np), self._dev(b_np),
            self._dev(dt_np), self._dev(pw_np), self._dev(g_np),
            self._dev(bucket), self._dev(tdev), self._dev(pseg),
            self._dev(pk), self._dev(pwp), self._dev(kts), self._dev(kvs),
            self._dev(cums), self._dev(pers), self._dev(tbr),
            n_dev=self.n_dev, nb=nb, n_tier=len(tier_names))
        energy_j = ej.reshape(self.n_dev, 3).tolist()
        dur_s = ds.reshape(self.n_dev, 3).tolist()
        cums_l = cums_nb.tolist()
        timeline = [(min((j + 1) * bin_s, end), cums_l[j])
                    for j in range(nb)]
        tier_billed = dict(zip(tier_names, tier_s.tolist()))
        per_dev_l = per_dev.tolist()
        self._sync()
        self.t["energy_s"] += time.perf_counter() - t1
        return energy_j, dur_s, per_dev_l, timeline, tier_billed


def compiled_program_count() -> int:
    """How many compiled programs the torch backend holds in this
    process: the CUDA libraries ``kernels/_build.py`` has built or
    loaded.  Eager PyTorch keeps no jit cache, so this is not a count of
    traced programs: a sweep pays its one build-and-load at its first
    point on the card and adds 0 after it (on the CPU, where no kernel
    launches, it stays 0).  The batched planner reports the delta per
    sweep."""
    from repro_torch.kernels import _build
    return _build.loaded()


# ---------------------------------------------------------------------------
# Sweeps: many production-shaped days, their arrivals sampled on the device.
# ---------------------------------------------------------------------------

def _diurnal_hr_t(base_hr: float, t: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``traces._diurnal_hr`` (same day shape, same order
    of operations)."""
    h = (t / 3600.0) % 24.0
    return base_hr * (0.55 + 0.45 * torch.sin((h - 9.0) * math.pi / 12.0))


def _flash_rate(base_rate_hr: float, spike_x: float, spike_start_s: float,
                spike_width_s: float):
    """Route 0 of ``traces.flash_crowd``: the diurnal baseline times
    ``1 + spike_x`` over the spike, then an exponential cool-down."""
    tail_s = 2.0 * spike_width_s

    def rate(t: torch.Tensor) -> torch.Tensor:
        r = _diurnal_hr_t(base_rate_hr, t)
        dt = t - spike_start_s
        hot = (dt >= 0.0) & (dt < spike_width_s)
        cool = (dt >= spike_width_s) & (dt < spike_width_s + tail_s)
        boost = hot.to(t.dtype) * spike_x + torch.where(
            cool, spike_x * torch.exp(-(dt - spike_width_s)
                                      / (0.35 * spike_width_s)), 0.0)
        return r * (1.0 + boost)

    return rate


def _launch_rate(t: torch.Tensor) -> torch.Tensor:
    """Route 0 of ``traces.product_launch`` at its default launch: zero
    before 9 h, then 600/h decaying to 60/h over 4 h."""
    dt = t - 9 * 3600.0
    surge = 60.0 + (600.0 - 60.0) * torch.exp(-torch.clamp(dt, min=0.0)
                                              / (4 * 3600.0))
    return torch.where(dt >= 0.0, surge, 0.0)


def _outage_rate(base_rate_hr: float):
    """Every route of ``traces.regional_outage`` at its default outage:
    dark over [11 h, 12 h), then 3x the baseline for 30 minutes."""
    out0, out1 = 11 * 3600.0, 12 * 3600.0

    def rate(t: torch.Tensor) -> torch.Tensor:
        r = _diurnal_hr_t(base_rate_hr, t)
        dark = (t >= out0) & (t < out1)
        surge = (t >= out1) & (t < out1 + 1800.0)
        return torch.where(dark, 0.0, torch.where(surge, r * 3.0, r))

    return rate


def sweep_rates(generator: str, n_routes: int, *, base_rate_hr: float,
                spike_x: float, spike_start_s: float, spike_width_s: float
                ) -> List[Tuple[List[int],
                                Callable[[torch.Tensor], torch.Tensor],
                                float]]:
    """The rate families of one sweep day: ``(route indices, rate
    function of t in seconds -> arrivals per hour, envelope rate)`` per
    family, each route in exactly one."""
    if generator not in ("flash-crowd", "product-launch",
                         "regional-outage"):
        raise KeyError(f"unknown sweep generator {generator!r}")

    def base(t):
        return _diurnal_hr_t(base_rate_hr, t)

    rest = list(range(1, n_routes))
    if generator == "flash-crowd":
        return [([0], _flash_rate(base_rate_hr, spike_x, spike_start_s,
                                  spike_width_s),
                 base_rate_hr * (1.0 + spike_x)),
                (rest, base, base_rate_hr)]
    if generator == "product-launch":
        return [([0], _launch_rate, 600.0), (rest, base, base_rate_hr)]
    return [(list(range(n_routes)), _outage_rate(base_rate_hr),
             base_rate_hr * 3.0)]


def _envelope_n(rate_max_hr: float, horizon_s: float) -> int:
    """The static sample width of a family: the envelope's mean count
    plus ~10 sigma of headroom."""
    lam = rate_max_hr * horizon_s / 3600.0
    return int(lam + 10.0 * math.sqrt(lam + 1.0) + 20.0)


def _sample_group(child_seeds: Sequence[int], rate_fn, rate_max: float,
                  horizon_s: float, n_max: int, device: torch.device
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Thinned inhomogeneous Poisson on ``device`` at a static shape,
    one row per route: each route draws from its own generator on the
    device, seeded with its child seed, the envelope count (clamped to
    ``n_max``), ``n_max`` uniform times and ``n_max`` uniform marks in
    float64, in that order, so a route's day depends on its seed alone.
    The whole group is then thinned (``keep = i < count & mark <
    rate(t)``) and sorted at once, rejected samples sent to +inf, and
    copied to the host in one transfer."""
    rows = len(child_seeds)
    f64 = torch.float64
    lam = torch.full((1,), rate_max * horizon_s / 3600.0, dtype=f64,
                     device=device)
    t = torch.empty((rows, n_max), dtype=f64, device=device)
    u = torch.empty_like(t)
    cnt = torch.empty(rows, dtype=f64, device=device)
    for r, seed in enumerate(child_seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        cnt[r:r + 1] = torch.poisson(lam, generator=gen)
        t[r].uniform_(0.0, horizon_s, generator=gen)
        u[r].uniform_(0.0, rate_max, generator=gen)
    n = torch.clamp(cnt, max=float(n_max)).to(torch.int64)
    keep = ((torch.arange(n_max, device=device)[None, :] < n[:, None])
            & (u < rate_fn(t)))
    ts = torch.where(keep, t, math.inf).sort(dim=1).values
    return ts.cpu().numpy(), keep.sum(dim=1).cpu().numpy()


def sweep_traces(seeds: Sequence[int], *, generator: str = "flash-crowd",
                 n_routes: int = 8, fleet: str = "2xh100+2xa100+2xl40s",
                 horizon_s: float = DAY, base_rate_hr: float = 40.0,
                 spike_x: float = 40.0,
                 spike_start_s: float = 13 * 3600.0,
                 spike_width_s: float = 1800.0,
                 device: Optional[str] = None) -> List[FleetTrace]:
    """A batch of production-shaped days with their arrivals sampled on
    ``device`` (``None`` means the GPU; see ``resolve_device``).

    Each point keeps the numpy generators' route plan: child seeds and
    checkpoint sizes come from ``traces._route_plan`` on the point's
    seed.  The day shapes are those of ``traces.flash_crowd`` /
    ``product_launch`` / ``regional_outage`` (the last two at their
    default launch and outage), and all routes of all points that share
    a rate family are thinned in one batch (``_sample_group``).  Each
    route samples from its own device generator seeded with its child
    seed, so the same seeds give a bit-identical batch on one device,
    and a point's day is the same whichever other seeds share the
    batch.  The streams are PyTorch's, not numpy's: the days are
    statistically, not bitwise, the numpy generators' days, and CPU and
    CUDA generators give different streams."""
    groups = sweep_rates(generator, n_routes, base_rate_hr=base_rate_hr,
                         spike_x=spike_x, spike_start_s=spike_start_s,
                         spike_width_s=spike_width_s)
    dev = resolve_device(device)
    plans = [_route_plan(np.random.default_rng(int(s)), n_routes)
             for s in seeds]
    # (point, route) -> (family, row in that family's sample)
    where: Dict[Tuple[int, int], Tuple[int, int]] = {}
    sampled = []
    for gi, (routes, rate_fn, rmax) in enumerate(groups):
        child = []
        for p, (child_seeds, _) in enumerate(plans):
            for i in routes:
                where[(p, i)] = (gi, len(child))
                child.append(int(child_seeds[i]))
        sampled.append(_sample_group(
            child, rate_fn, rmax, horizon_s, _envelope_n(rmax, horizon_s),
            dev) if child else None)
    traces: List[FleetTrace] = []
    for p, (seed, (_, ckpt)) in enumerate(zip(seeds, plans)):
        routes = []
        for i in range(n_routes):
            gi, row = where[(p, i)]
            ts, cnt = sampled[gi]
            routes.append(RouteTrace(
                route_id=f"r{i}", arrivals_s=ts[row, :int(cnt[row])].copy(),
                checkpoint_gb=float(ckpt[i])))
        traces.append(FleetTrace(name=f"{generator}-sweep", fleet=fleet,
                                 horizon_s=horizon_s, routes=tuple(routes),
                                 seed=int(seed)))
    return traces


def run_mega_sweep(scenarios=None, *, seeds: Optional[Sequence[int]] = None,
                   policy_factory=None, router: str = "warm-first",
                   compute_bound: bool = False,
                   scenario_kw: Optional[dict] = None,
                   on_unsupported: str = "raise",
                   device: Optional[str] = None,
                   **trace_kw) -> List[Optional[FleetResult]]:
    """Run a sweep of mega days on the torch backend: either explicit
    ``scenarios`` (any ``FleetScenario`` in run_mega's scope) or
    ``seeds`` + generator kwargs (``generator=``, ``n_routes=``,
    ``fleet=``, ... -- see ``sweep_traces``), whose arrivals are then
    sampled on ``device`` in one batch per rate family.

    The points replay through ``run_mega(backend="torch",
    device=device)`` one after another (the structural event loop is
    serial); the CUDA libraries load at the first point on the card and
    are shared by the rest.  Returns one ``FleetResult`` per point, in
    input order.  ``on_unsupported="skip"`` returns ``None`` for points
    outside run_mega's scope (``MegaUnsupportedError``) instead of
    raising -- the seam the batched planner dispatches event-loop
    fallbacks behind."""
    if (scenarios is None) == (seeds is None):
        raise ValueError("pass exactly one of scenarios= or seeds=")
    if on_unsupported not in ("raise", "skip"):
        raise ValueError(f"on_unsupported={on_unsupported!r}")
    if seeds is not None:
        if policy_factory is None:
            from repro_torch.core.scheduler import Breakeven
            policy_factory = Breakeven
        traces = sweep_traces(seeds, device=device, **trace_kw)
        scenarios = [tr.to_scenario(policy_factory, router,
                                    **(scenario_kw or {}))
                     for tr in traces]
    elif trace_kw:
        raise ValueError(f"trace kwargs {sorted(trace_kw)} need seeds=")
    out: List[Optional[FleetResult]] = []
    for sc in scenarios:
        try:
            out.append(megasim.run_mega(sc, compute_bound=compute_bound,
                                        backend="torch", device=device))
        except megasim.MegaUnsupportedError:
            if on_unsupported != "skip":
                raise
            out.append(None)
    return out
