"""Launch wrappers of the CUDA metering kernels in
``csrc/segment_trapz.cu``: ``fused_meter`` and ``segment_trapz``
(ports of the Pallas kernels of ``repro/kernels/segment_trapz.py``)
and ``ordered_segment_sum`` (the in-order per-key sum behind the
bit-exact energy buckets; not a port of a TPU kernel).

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch returns a
CUDA error, and adds one to its entry of ``LAUNCHES`` per launch.
``kernels/ops.py`` routes CPU tensors to the plain versions in
``kernels/ref.py`` instead.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches per wrapper since the last reset (ops.reset_launches)
LAUNCHES: Dict[str, int] = {"fused_meter": 0, "segment_trapz": 0,
                            "ordered_segment_sum": 0}

# dynamic shared memory a block may use without opting in
_SMEM_BYTES = 48 * 1024

_P = ctypes.c_void_p
_SIGS = {
    "fused_meter_f64": [_P] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, _P],
    "segment_trapz_f64": [_P] * 6 + [ctypes.c_double, _P,
                                     ctypes.c_longlong, ctypes.c_int, _P],
    "ordered_segment_sum_f64": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, _P],
}


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
    """a, b, w: [N] float64; kt, kv, cum: [K] float64 knot tables of one
    trace with period ``period``.  Returns [N] ``w*(F(b)-F(a))``."""
    dev = a.device
    for nm, t in (("a", a), ("b", b), ("w", w), ("kt", kt), ("kv", kv),
                  ("cum", cum)):
        _check(f"segment_trapz {nm}", t, torch.float64, 1, dev)
    n = a.shape[0]
    if b.shape[0] != n or w.shape[0] != n:
        raise ValueError("segment_trapz: a, b, w must share one length")
    K = kt.shape[0]
    if kv.shape[0] != K or cum.shape[0] != K or K < 2:
        raise ValueError("segment_trapz: need K >= 2 knots in each table")
    if 3 * K * 8 > _SMEM_BYTES:
        raise ValueError(f"segment_trapz: K={K} knots do not fit the "
                         f"kernel's {_SMEM_BYTES} B of shared memory")
    out = torch.empty_like(a)
    if n == 0:
        return out
    _launch("segment_trapz", "segment_trapz_f64", dev,
            *(t.data_ptr() for t in (a, b, w, kt, kv, cum)),
            float(period), out.data_ptr(), n, K)
    return out


def ordered_segment_sum(vals: torch.Tensor, keys: torch.Tensor,
                        num: int) -> torch.Tensor:
    """vals: [C, N] float64; keys: [N] int64 in [0, num).  Returns
    [C, num]: each key's entries summed in index order from 0.0.  The
    stable sort and run offsets are PyTorch calls; the kernel walks
    each run in order."""
    dev = vals.device
    _check("ordered_segment_sum vals", vals, torch.float64, 2, dev)
    _check("ordered_segment_sum keys", keys, torch.int64, 1, dev)
    C, n = vals.shape
    if keys.shape[0] != n:
        raise ValueError("ordered_segment_sum: keys must be [N] for vals "
                         "[C, N]")
    out = torch.zeros(C, num, dtype=torch.float64, device=dev)
    if n == 0 or num == 0:
        return out
    order = torch.sort(keys, stable=True).indices
    offsets = torch.zeros(num + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(keys, minlength=num)[:num], 0,
                 out=offsets[1:])
    _launch("ordered_segment_sum", "ordered_segment_sum_f64", dev,
            vals.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), n, C, num)
    return out
