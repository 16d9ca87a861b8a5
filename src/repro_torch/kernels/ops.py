"""Dispatch for the port's kernels: a CUDA tensor launches the
hand-written kernel (``kernels/segment_trapz.py``,
``kernels/flash_attention.py``, ``kernels/decode_attention.py``,
``kernels/rglru_scan.py``), a CPU tensor takes the plain PyTorch
version (``kernels/ref.py``).  This is the reference's
``use_pallas=None`` policy -- the kernel on real hardware, the plain
version where no kernel can run -- decided by where the tensor lies,
with no fallback for a CUDA tensor: it launches or raises.  A DTensor
raises on either device.
``flash_attention`` and ``rglru_scan`` are differentiable on both
devices: on the card through the wrappers' autograd functions
(``FlashAttention``: on the float32 f32tc route the forward kernel and
its backward kernel, on the others the forward kernel with the plain
version's gradient; ``RGLRUScan``: the scan kernel in both passes), on
the CPU through the plain versions themselves.

``launch_counts()`` reads the kernel launches per op since the last
``reset_launches()`` (plain-version calls never count; the f32tc
backward counts as ``flash_attention_bwd``), so a caller can show that a
run really went through the kernels; ``route_counts()`` splits the
``flash_attention`` launches by the kernel that took them,
``route_counts("decode_attention")`` its calls by ``"split"`` /
``"single"``, ``route_counts("rglru_scan")`` by ``"chunked"`` /
``"serial"``.

A fake tensor (no data: a dry run's trace, ``launch/dryrun``) on the
card reaches the wrappers as a real one would and takes their fake
branch, which launches nothing; ``fake_launch_counts()``,
``fake_route_counts()`` and ``fake_work()`` read what it would have
launched (reset by ``reset_launches()`` too).  Inside ``card_trace()`` a
fake tensor on the CPU stands for one on the card: a CPU-only build of
PyTorch cannot run autograd or Python indexing on fake ``cuda`` tensors
(both open a CUDA device guard it does not have), so a dry run there
traces the card's program on fake CPU tensors.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import segment_trapz as _cuda

_COUNTERS = (_cuda.LAUNCHES, _flash.LAUNCHES, _decode.LAUNCHES,
             _rglru.LAUNCHES)


_ROUTES = {"flash_attention": _flash.ROUTES,
           "decode_attention": _decode.ROUTES,
           "rglru_scan": _rglru.ROUTES}
_FAKE = {"flash_attention": _flash.FAKE, "decode_attention": _decode.FAKE,
         "rglru_scan": _rglru.FAKE}
_CARD_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "card_trace", default=False)


def reset_launches() -> None:
    for counts in _COUNTERS + tuple(_ROUTES.values()):
        for k in counts:
            counts[k] = 0
    for tally in _FAKE.values():
        tally.reset()


def launch_counts() -> Dict[str, int]:
    return {k: n for counts in _COUNTERS for k, n in counts.items()}


def route_counts(op: str = "flash_attention") -> Dict[str, int]:
    """``op``'s kernel calls per route since the last
    ``reset_launches()``: ``flash_attention`` (the default) by kernel
    (``"sm90"``, ``"f32tc"``, ``"simt"``), ``decode_attention`` by
    ``"split"`` /
    ``"single"``, ``rglru_scan`` by ``"chunked"`` / ``"serial"``."""
    return dict(_ROUTES[op])


def fake_launch_counts() -> Dict[str, int]:
    """The launches per op a trace on fake tensors made since the last
    ``reset_launches()`` (``launch_counts()``'s keys but the metering
    kernels', which no traced path reaches)."""
    return {k: n for t in _FAKE.values() for k, n in t.launches.items()}


def fake_route_counts(op: str = "flash_attention") -> Dict[str, int]:
    """``route_counts(op)`` of the fake launches."""
    return dict(_FAKE[op].routes)


def fake_work() -> Dict[str, Dict[str, int]]:
    """Per op, the operations and bytes of its fake launches (the kernel
    table's yardstick: ``work`` of each kernel module)."""
    return {k: {"operations": t.operations[k], "bytes": t.bytes[k]}
            for t in _FAKE.values() for k in t.launches}


@contextlib.contextmanager
def card_trace():
    """Inside, a fake tensor on the CPU takes the card's path (the
    kernel wrappers' fake branch) in place of the plain version."""
    tok = _CARD_TRACE.set(True)
    try:
        yield
    finally:
        _CARD_TRACE.reset(tok)


def _on_cuda(op: str, t: torch.Tensor) -> bool:
    if isinstance(t, DTensor):
        # the kernels read raw data_ptr()s: a sharded step body hands
        # them its local tensors (``launch/steps.jit_cell``)
        raise TypeError(f"{op}: got a DTensor; pass plain (local) tensors")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return _CARD_TRACE.get() and _flash.is_fake(t)
    raise ValueError(f"{op}: tensors on {t.device} are not supported "
                     f"(expected cuda or cpu)")


def segment_trapz(a, b, w, kt, kv, cum, *, period: float) -> torch.Tensor:
    """Per-segment trapezoid integrals ``w * (F(b) - F(a))`` of one
    periodic piecewise-linear carbon curve (see ``ref.segment_trapz_ref``).
    """
    if _on_cuda("segment_trapz", a):
        return _cuda.segment_trapz(a, b, w, kt, kv, cum, period=period)
    return ref.segment_trapz_ref(a, b, w, kt, kv, cum, period=period)


def fused_meter(a, b, dt, w, g, kt, kv, cum, periods):
    """Fused metering pass: per charge-log entry energy, billed seconds,
    carbon increment and start prefix (see ``ref.fused_meter_ref``)."""
    if _on_cuda("fused_meter", a):
        return _cuda.fused_meter(a, b, dt, w, g, kt, kv, cum, periods)
    return ref.fused_meter_ref(a, b, dt, w, g, kt, kv, cum, periods)


def ordered_segment_sum(vals, keys, num: int) -> torch.Tensor:
    """Per-key sums of ``vals`` [C, N], each key's entries added in
    index order (see ``ref.ordered_segment_sum_ref``)."""
    if _on_cuda("ordered_segment_sum", vals):
        return _cuda.ordered_segment_sum(vals, keys, num)
    return ref.ordered_segment_sum_ref(vals, keys, num)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Prefill attention, q [B,H,S,D] (row i at position ``q_offset + i``)
    against k, v [B,Hkv,T,D], scores capped by ``softcap`` (see
    ``ref.flash_attention_ref``).  Differentiable at ``q_offset`` 0 only
    (on the card a gradient at an offset raises)."""
    if _on_cuda("flash_attention", q):
        return _flash.FlashAttention.apply(q, k, v, causal, window, softcap,
                                           q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)


def decode_attention(q, k, v, length, *,
                     softcap: Optional[float] = None, lse: bool = False):
    """One-token attention, q [B,H,D] against the first ``length`` rows
    of k, v [B,Hkv,T,D], scores capped by ``softcap`` (see
    ``ref.decode_attention_ref``).  A row of
    length 0 gives exactly 0 on either device, as the kernel and the
    reference's Pallas kernel (``acc / max(l, 1e-20)``) give; the plain
    version alone would give NaN there (a softmax over no key).  With
    ``lse`` returns (out, the [B,H] float32 log-sum-exps; -inf on a row
    of length 0), see ``ref.decode_attention_lse_ref``."""
    if _on_cuda("decode_attention", q):
        return _decode.decode_attention(q, k, v, length, softcap=softcap,
                                        lse=lse)
    if lse:
        return ref.decode_attention_lse_ref(q, k, v, length,
                                            softcap=softcap)
    out = ref.decode_attention_ref(q, k, v, length, softcap=softcap)
    empty = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1) <= 0
    return out.masked_fill(empty, 0)


def rglru_scan(a, b, h0) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` over a, b
    [B,S,W] from h0 [B,W] (see ``ref.rglru_scan_ref``)."""
    if _on_cuda("rglru_scan", a):
        return _rglru.RGLRUScan.apply(a, b, h0)
    return ref.rglru_scan_ref(a, b, h0)
