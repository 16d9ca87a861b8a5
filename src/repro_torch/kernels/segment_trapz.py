"""Launch wrappers of the CUDA metering kernels in
``csrc/segment_trapz.cu``: ``fused_meter`` and ``segment_trapz``
(ports of the Pallas kernels of ``repro/kernels/segment_trapz.py``)
and ``ordered_segment_sum`` (the in-order per-key sum behind the
bit-exact energy buckets; not a port of a TPU kernel).

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs (and scratch) with ``torch.empty``,
launches on the current stream without synchronising, raises if the
launch returns a CUDA error, and adds one to its entry of ``LAUNCHES``
per call (``ordered_segment_sum``'s four kernels are one call).
``kernels/ops.py`` routes CPU tensors to the plain versions in
``kernels/ref.py`` instead.

The launch plans are functions of shapes alone, so the CPU tests reach
them: ``trapz_plan`` (``segment_trapz``'s persistent blocks and their
tiles) and ``sort_plan`` (``ordered_segment_sum``'s counting-sort
tiles).  ``trapz_align_check`` and ``sort_limits`` raise on what the
kernels do not take: a base off the 16-byte grid (the bulk copies and
16-byte stores), more than ``SORT_MAX_NUM`` keys or ``SORT_MAX_C``
channels.  Nothing here falls back to another path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches per wrapper since the last reset (ops.reset_launches)
LAUNCHES: Dict[str, int] = {"fused_meter": 0, "segment_trapz": 0,
                            "ordered_segment_sum": 0}

# dynamic shared memory a fused_meter block may use (no opt-in)
_SMEM_BYTES = 48 * 1024
# knots a segment_trapz table may hold: its search is instantiated for
# ceil(log2 K) <= 11 steps (csrc STEPS_CASES)
MAX_KNOTS = 2048

# segment_trapz: entries a tile (csrc kTile) and persistent blocks an SM
TRAPZ_TILE = 1024
TRAPZ_BLOCKS_PER_SM = 2
# ordered_segment_sum: a counting-sort tile is a multiple of SORT_TILE
# entries (csrc kSortTile); keys per call (a block keeps a 32-bit counter
# a key in shared memory: 192 KB) and channels (csrc kMaxNum,
# kMaxChannels)
SORT_TILE = 2048
SORT_MAX_NUM = 49152
SORT_MAX_C = 4

_P = ctypes.c_void_p
_SIGS = {
    "fused_meter_f64": [_P] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, _P],
    "segment_trapz_f64": [_P] * 6 + [ctypes.c_double, _P,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _P],
    "ordered_segment_sum_f64": [_P] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, _P],
    "dadd_chain_f64": [ctypes.c_double, ctypes.c_longlong, _P, _P],
}


class TrapzPlan(NamedTuple):
    """``segment_trapz``'s launch: ``blocks`` persistent blocks over
    ``tiles`` tiles of ``TRAPZ_TILE`` entries, of which the first
    ``full_tiles`` go through the shared-memory ring (bulk copies) and
    the last partial one, if any, is read with plain loads."""
    blocks: int
    tiles: int
    full_tiles: int


def trapz_plan(n: int, sms: int) -> TrapzPlan:
    """The plan for ``n`` entries on a card of ``sms`` SMs."""
    tiles = -(-n // TRAPZ_TILE)
    return TrapzPlan(max(1, min(tiles, TRAPZ_BLOCKS_PER_SM * sms)), tiles,
                     n // TRAPZ_TILE)


def trapz_tiles(plan: TrapzPlan, block: int) -> range:
    """The tiles block ``block`` computes, in its order (as the kernel's
    loop ``t = blockIdx.x; t < tiles; t += gridDim.x``)."""
    return range(block, plan.tiles, plan.blocks)


class SortPlan(NamedTuple):
    """``ordered_segment_sum``'s counting sort: ``tiles`` tiles of
    ``tile`` entries, one histogram row and one scatter warp each."""
    tile: int
    tiles: int


def sort_plan(n: int, num: int) -> SortPlan:
    """The plan for ``n`` entries over ``num`` keys: a tile of at least
    ``num`` entries (a multiple of SORT_TILE), so the histogram rows
    (tiles x num counters) hold no more counters than the tiles hold
    entries."""
    tile = SORT_TILE * max(1, -(-num // SORT_TILE))
    return SortPlan(tile, -(-n // tile))


def sort_limits(n: int, C: int, num: int) -> None:
    """Raise unless the counting sort takes ``C`` channels of ``n``
    entries over ``num`` keys."""
    if num > SORT_MAX_NUM:
        raise ValueError(f"ordered_segment_sum: num={num} keys exceed the "
                         f"kernel's limit of {SORT_MAX_NUM} (a 32-bit "
                         f"counter a key in one block's shared memory)")
    if C > SORT_MAX_C:
        raise ValueError(f"ordered_segment_sum: C={C} channels exceed the "
                         f"kernel's limit of {SORT_MAX_C}")
    if n >= 2 ** 31:
        raise ValueError(f"ordered_segment_sum: N={n} entries exceed the "
                         f"kernel's 32-bit positions")


def trapz_align_check(ts, names) -> None:
    """Raise unless every tensor's base lies on the 16-byte grid, as
    ``segment_trapz``'s bulk copies and 16-byte stores need; a
    misaligned tensor is never copied."""
    for t, nm in zip(ts, names):
        if t.data_ptr() % 16:
            raise ValueError(
                f"segment_trapz {nm}: the kernel reads by 16-byte bulk "
                f"copies and needs a 16-byte aligned base; got base offset "
                f"{t.data_ptr() % 16} B")


def _knots(op: str, K: int) -> None:
    if K < 2 or K > MAX_KNOTS:
        raise ValueError(f"{op}: need 2 <= K <= {MAX_KNOTS} knots in each "
                         f"table, got K={K}")


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fn(name: str):
    fn = getattr(_build.load("segment_trapz"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


def fused_meter(a, b, dt, w, g, kt, kv, cum, periods
                ) -> Tuple[torch.Tensor, ...]:
    """a, b, dt, w: [N] float64; g: [N] int32 table row per entry;
    kt, kv, cum: [G, K] float64 stacked knot tables; periods: [G].
    Returns ``(w*dt, dt, w*(F_g(b)-F_g(a)), F_g(a))``, each [N]."""
    dev = a.device
    for nm, t in (("a", a), ("b", b), ("dt", dt), ("w", w)):
        _check(f"fused_meter {nm}", t, torch.float64, 1, dev)
    _check("fused_meter g", g, torch.int32, 1, dev)
    for nm, t in (("kt", kt), ("kv", kv), ("cum", cum)):
        _check(f"fused_meter {nm}", t, torch.float64, 2, dev)
    _check("fused_meter periods", periods, torch.float64, 1, dev)
    n = a.shape[0]
    if any(t.shape[0] != n for t in (b, dt, w, g)):
        raise ValueError("fused_meter: a, b, dt, w, g must share one length")
    G, K = kt.shape
    if kv.shape != kt.shape or cum.shape != kt.shape or \
            periods.shape[0] != G:
        raise ValueError("fused_meter: tables must be [G, K] and periods [G]")
    if G < 1 or K < 2:
        raise ValueError("fused_meter: need G >= 1 rows of K >= 2 knots")
    if (3 * G * K + G) * 8 > _SMEM_BYTES:
        raise ValueError(f"fused_meter: tables of G={G} x K={K} do not fit "
                         f"the kernel's {_SMEM_BYTES} B of shared memory")
    outs = tuple(torch.empty_like(a) for _ in range(4))
    if n == 0:
        return outs
    _launch("fused_meter", "fused_meter_f64", dev,
            *(t.data_ptr() for t in (a, b, dt, w, g, kt, kv, cum, periods)),
            *(o.data_ptr() for o in outs), n, G, K)
    return outs


def segment_trapz(a, b, w, kt, kv, cum, *, period: float) -> torch.Tensor:
    """a, b, w: [N] float64, 16-byte aligned; kt, kv, cum: [K] float64
    knot tables of one trace with period ``period``.  Returns [N]
    ``w*(F(b)-F(a))``."""
    dev = a.device
    for nm, t in (("a", a), ("b", b), ("w", w), ("kt", kt), ("kv", kv),
                  ("cum", cum)):
        _check(f"segment_trapz {nm}", t, torch.float64, 1, dev)
    n = a.shape[0]
    if b.shape[0] != n or w.shape[0] != n:
        raise ValueError("segment_trapz: a, b, w must share one length")
    K = kt.shape[0]
    if kv.shape[0] != K or cum.shape[0] != K:
        raise ValueError("segment_trapz: kt, kv, cum must share one length")
    _knots("segment_trapz", K)
    out = torch.empty_like(a)
    if n == 0:
        return out
    trapz_align_check((a, b, w, out), ("a", "b", "w", "out"))
    plan = trapz_plan(n, _sms(dev))
    _launch("segment_trapz", "segment_trapz_f64", dev,
            *(t.data_ptr() for t in (a, b, w, kt, kv, cum)),
            float(period), out.data_ptr(), n, K, plan.blocks, TRAPZ_TILE)
    return out


def ordered_segment_sum(vals: torch.Tensor, keys: torch.Tensor,
                        num: int) -> torch.Tensor:
    """vals: [C, N] float64 (C <= SORT_MAX_C); keys: [N] int64 in
    [0, num), num <= SORT_MAX_NUM (an entry with a key outside is left
    out).  Returns [C, num]: each key's entries summed in index order
    from 0.0.  One call launches the counting sort's histogram, scan
    and scatter kernels and the in-order walk (``sort_plan``), with
    scratch from ``torch.empty``."""
    dev = vals.device
    _check("ordered_segment_sum vals", vals, torch.float64, 2, dev)
    _check("ordered_segment_sum keys", keys, torch.int64, 1, dev)
    C, n = vals.shape
    if keys.shape[0] != n:
        raise ValueError("ordered_segment_sum: keys must be [N] for vals "
                         "[C, N]")
    sort_limits(n, C, num)
    if n == 0 or num == 0 or C == 0:
        return torch.zeros(C, num, dtype=torch.float64, device=dev)
    plan = sort_plan(n, num)
    out = torch.empty(C, num, dtype=torch.float64, device=dev)
    counts = torch.empty(plan.tiles * num, dtype=torch.int32, device=dev)
    totals = torch.empty(num, dtype=torch.int32, device=dev)
    starts = torch.empty(num + 1, dtype=torch.int32, device=dev)
    ordered = torch.empty(n, C, dtype=torch.float64, device=dev)
    _launch("ordered_segment_sum", "ordered_segment_sum_f64", dev,
            *(t.data_ptr() for t in (vals, keys, counts, totals, starts,
                                     ordered, out)), n, C, num, plan.tile)
    return out

