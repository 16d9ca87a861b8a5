"""Plain PyTorch versions of the port's kernels (the allclose targets).

These are the semantics the CUDA kernels in ``csrc/`` must match: the
CPU path of ``kernels/ops.py`` runs them, and ``chip_smoke.py`` holds
each kernel against them on the card.  The metering functions are
float64 (the fleet accounting convention); the attention functions and
the RG-LRU scan take float32 or bfloat16 and compute in float32.  None
of them changes the global default dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,S,D]; k,v: [B,Hkv,T,D] with H a multiple of Hkv.
    Positions are 0..S-1 / 0..T-1 (prefill semantics).  A row with no
    valid key is NaN (a softmax over -inf only)."""
    b, h, s, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) / math.sqrt(d)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= qi - ki < window
    scores = scores.masked_fill(~mask, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length) -> torch.Tensor:
    """Single-token GQA decode.  q: [B,H,D]; k,v: [B,Hkv,T,D]; ``length``
    (an int or a [B] tensor) = number of valid cache entries per row
    (attend to positions < length)."""
    b, h, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhd,bhtd->bht", q.float(), kk) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
    valid = torch.arange(t, device=q.device)[None, None, :] < length
    scores = scores.masked_fill(~valid, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bhtd->bhd", w, vv).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``,
    one step at a time.  a, b: [B,S,W]; h0: [B,W].  The state is float32
    (a, b and h0 are widened to it); each h_t is returned in a's dtype,
    as the Pallas kernel writes it."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def prefix_integral(t: torch.Tensor, kt: torch.Tensor, kv: torch.Tensor,
                    cum: torch.Tensor, per) -> torch.Tensor:
    """F(t) = integral over [0, t] of the periodic piecewise-linear curve
    with extended knot times ``kt``, values ``kv`` and prefix trapezoid
    integrals ``cum`` (``CarbonTrace`` internals): whole periods times
    the one-period integral plus the in-period trapezoid prefix, with
    the knot index ``bisect_right(kt, p) - 1`` clipped to [0, K-2].
    Tables run along their last axis: one [K] table for t of any shape,
    or [R, K] row tables for t [R, T]."""
    k = torch.floor(t / per)
    p = t - k * per
    j = torch.clamp(torch.searchsorted(kt, p, right=True) - 1,
                    0, kt.shape[-1] - 2)
    kt_j = kt.gather(-1, j)
    kv_j = kv.gather(-1, j)
    span = kt.gather(-1, j + 1) - kt_j
    d = p - kt_j
    v_p = kv_j + (kv.gather(-1, j + 1) - kv_j) * d \
        / torch.where(span > 0, span, torch.ones_like(span))
    return k * cum[..., -1:] + cum.gather(-1, j) + d * (kv_j + v_p) * 0.5


def segment_trapz_ref(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                      kt: torch.Tensor, kv: torch.Tensor, cum: torch.Tensor,
                      *, period: float) -> torch.Tensor:
    """Per-segment trapezoid integrals of a periodic piecewise-linear
    curve: ``out_i = w_i * (F(b_i) - F(a_i))`` with F the prefix
    integral of the curve described by extended knots (kt, kv) and
    prefix integrals cum over [0, period] (``CarbonTrace`` internals).
    a, b, w: [N]; kt, kv, cum: [K]."""
    return w * (prefix_integral(b, kt, kv, cum, period)
                - prefix_integral(a, kt, kv, cum, period))


def fused_meter_ref(a: torch.Tensor, b: torch.Tensor, dt: torch.Tensor,
                    w: torch.Tensor, g: torch.Tensor,
                    kt: torch.Tensor, kv: torch.Tensor, cum: torch.Tensor,
                    periods: torch.Tensor):
    """Fused metering pass: per charge-log entry emit energy ``w * dt``,
    seconds ``dt``, carbon increment ``w * (F_g(b) - F_g(a))``, and
    ``F_g(a)``.  kt, kv, cum are stacked ``[G, K]`` extended knot tables
    (rows padded by repeating the last knot); g: [N] int32 selects each
    entry's row; periods: [G].  ``dt`` is passed through, never
    recomputed as ``b - a``."""
    gi = g.long()
    rows = (kt[gi], kv[gi], cum[gi], periods[gi][:, None])   # [N, K]

    def F(t):
        return prefix_integral(t[:, None], *rows)[:, 0]

    fa = F(a)
    return w * dt, dt, w * (F(b) - fa), fa


def ordered_segment_sum_ref(vals: torch.Tensor, keys: torch.Tensor,
                            num: int) -> torch.Tensor:
    """``out[c, k] = sum of vals[c, i] over i with keys[i] == k``, each
    key's entries added left to right in index order starting from 0.0
    -- the float rounding of the numpy mega backend's running
    ``energy_j[d][s] += dt * p``.  vals: [C, N]; keys: [N] int64 in
    [0, num).  Vectorised over keys, sequential over the rank of an
    entry within its key, so the order holds on any device."""
    out = torch.zeros(vals.shape[0], num, dtype=vals.dtype,
                      device=vals.device)
    if keys.numel() == 0:
        return out
    order = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=num)
    starts = torch.cumsum(counts, 0) - counts
    for r in range(int(counts.max())):
        live = torch.nonzero(counts > r).squeeze(1)
        idx = order[starts[live] + r]
        out[:, live] = out[:, live] + vals[:, idx]
    return out
