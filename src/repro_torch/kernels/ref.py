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


def _check_cap(softcap: Optional[float], q_offset: int) -> None:
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset}")


def cap_scores(scores: torch.Tensor,
               softcap: Optional[float]) -> torch.Tensor:
    """The reference's logit softcap (``repro/models/attention.py``
    ``_sdpa``): ``c * tanh(scores / c)`` on the scaled scores, before the
    mask; None leaves them as they are."""
    if softcap is None:
        return scores
    return softcap * torch.tanh(scores / softcap)


def _cap_and_mask(scores, mask, softcap, after_mask=False):
    """Scores capped, then masked with -inf (the kernels' order: a masked
    key keeps probability 0); ``after_mask`` is the planted fault of
    ``flash_attention_faults`` / ``decode_attention_faults``: capped after
    the mask, so a masked key sits at -c and leaks weight."""
    if after_mask:
        return cap_scores(scores.masked_fill(~mask, -math.inf), softcap)
    return cap_scores(scores, softcap).masked_fill(~mask, -math.inf)


def _position_mask(s: int, t: int, causal: bool, window: Optional[int],
                   q_offset: int, device) -> torch.Tensor:
    """[S, T] validity of key j for query row i at position
    ``q_offset + i``: causal masks j > q_offset + i, window masks
    q_offset + i - j >= window."""
    qi = q_offset + torch.arange(s, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= qi - ki < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B,H,S,D]; k,v: [B,Hkv,T,D] with H a multiple of Hkv.  Query
    row i sits at position ``q_offset + i`` and key j at position j (0 is
    prefill; above 0 a chunk of a prompt against the cache rows before
    it).  ``softcap`` caps the scaled scores before the mask
    (``cap_scores``).  A row with no valid key is NaN (a softmax over
    -inf only)."""
    return _flash_plain(q, k, v, causal, window, softcap, q_offset)


def _flash_plain(q, k, v, causal, window, softcap, q_offset,
                 after_mask=False):
    _check_cap(softcap, q_offset)
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) / math.sqrt(d)
    mask = _position_mask(s, k.shape[2], causal, window, q_offset, q.device)
    w = torch.softmax(_cap_and_mask(scores, mask, softcap, after_mask), -1)
    return torch.einsum("bhst,bhtd->bhsd", w, vv).to(q.dtype)


def flash_attention_faults(q, k, v, *, causal=True, window=None,
                           softcap=None, q_offset=0):
    """Wrong versions of ``flash_attention_ref`` (planted faults that the
    checks of the softcap and the query offset must reject): the cap
    dropped, the cap applied after the mask (masked keys at -c instead of
    -inf, so they leak weight), and the offset ignored (query rows at
    positions 0..S-1).  Only the faults that differ from the right
    version for these arguments.  Returns {name: [B,H,S,D]}."""
    out = {}
    if softcap is not None:
        out["cap dropped"] = _flash_plain(q, k, v, causal, window, None,
                                          q_offset)
        out["cap after the mask"] = _flash_plain(
            q, k, v, causal, window, softcap, q_offset, after_mask=True)
    if q_offset:
        out["offset ignored"] = _flash_plain(q, k, v, causal, window,
                                             softcap, 0)
    return out


def _flash_scores(q, k, v, causal, window, softcap=None, q_offset=0):
    """(scores [B,H,S,T] scaled, capped and masked with -inf, the mask, k
    and v repeated over each kv head's query heads), in float64 for
    float64 inputs and float32 otherwise."""
    _check_cap(softcap, q_offset)
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s, d = q.shape[2], q.shape[3]
    t = k.shape[2]
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).to(dt)
    vv = v.repeat_interleave(g, dim=1).to(dt)
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(dt), kk) / math.sqrt(d)
    mask = _position_mask(s, t, causal, window, q_offset, q.device)
    return _cap_and_mask(scores, mask, softcap), mask, kk, vv


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            q_offset: int = 0):
    """The f32tc kernel's forward: (out, lse).  out is
    ``flash_attention_ref``'s, with 0 (as the Pallas kernel's
    ``acc / max(l, 1e-20)`` gives) for a row that sees no key; lse
    [B,H,S] is the natural log-sum-exp of each row's scaled, capped,
    masked scores (-inf for such a row).  float64 inputs compute in
    float64."""
    scores, _, _, vv = _flash_scores(q, k, v, causal, window, softcap,
                                     q_offset)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(scores, dim=-1), vv)
    out = out.masked_fill(torch.isinf(lse)[..., None], 0)
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, causal, window, delta=True,
               group_sum=True, softcap=None, cap_grad=True):
    scores, mask, kk, vv = _flash_scores(q, k, v, causal, window, softcap)
    dt = scores.dtype
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    lse = lse.to(dt)[..., None]
    # P = exp(S - lse), 0 where masked (and on a row with lse = -inf)
    p = torch.exp(scores - lse.masked_fill(torch.isinf(lse), 0))
    p = p.masked_fill(~mask, 0)
    do = dout.to(dt)
    dp = torch.einsum("bhsd,bhtd->bhst", do, vv)
    rows = (do * out.to(dt)).sum(-1, keepdim=True) if delta else 0
    ds = p * (dp - rows)
    if softcap is not None and cap_grad:
        # d(c tanh(x / c)) / dx = 1 - (Sc / c)^2 at the capped score Sc
        ds = ds * torch.where(mask, 1 - (scores / softcap) ** 2, 0)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kk) / math.sqrt(d)
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.to(dt)) / math.sqrt(d)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do)
    if group_sum:
        dk, dv = (x.reshape(b, hkv, h // hkv, t, d).sum(2) for x in (dk, dv))
    else:
        dk, dv = dk[:, ::h // hkv], dv[:, ::h // hkv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The f32tc backward kernel's equations (FlashAttention-2's, not
    autograd): with the scores Sc = scale Q K^T (``cap_scores`` of it
    under a softcap), P = exp(Sc - lse) (0 where masked), dP = dO V^T,
    Delta = rowsum(dO * O) and dS = P * (dP - Delta), times
    1 - (Sc / c)^2 under a softcap c, dQ = scale dS K, dK = scale dS^T Q
    and dV = P^T dO, dK and dV summed over each kv head's query heads.
    Query rows sit at positions 0.. (no query offset).  Returns (dq, dk,
    dv) in q's, k's and v's dtypes; float64 inputs compute in float64,
    others in float32."""
    return _flash_bwd(q, k, v, out, lse, dout, causal, window,
                      softcap=softcap)


def flash_attention_bwd_faults(q, k, v, out, lse, dout, *, causal=True,
                               window=None, softcap=None):
    """Wrong backwards the gradient checks must reject: Delta dropped
    (dS = P * dP), dK / dV taken from the first query head of each group
    instead of the group's sum, and under a softcap dS without the cap's
    derivative 1 - (Sc / c)^2."""
    out_ = {
        "delta dropped": _flash_bwd(q, k, v, out, lse, dout, causal, window,
                                    delta=False, softcap=softcap),
        "one head of the group": _flash_bwd(q, k, v, out, lse, dout, causal,
                                            window, group_sum=False,
                                            softcap=softcap)}
    if softcap is not None:
        out_["no cap derivative"] = _flash_bwd(
            q, k, v, out, lse, dout, causal, window, softcap=softcap,
            cap_grad=False)
    return out_


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, *,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA decode.  q: [B,H,D]; k,v: [B,Hkv,T,D]; ``length``
    (an int or a [B] tensor) = number of valid cache entries per row
    (attend to positions < length); ``softcap`` caps the scaled scores
    before the mask (``cap_scores``)."""
    return _decode_plain(q, k, v, length, softcap)


def _decode_plain(q, k, v, length, softcap, after_mask=False):
    _check_cap(softcap, 0)
    b, h, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhd,bhtd->bht", q.float(), kk) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
    valid = torch.arange(t, device=q.device)[None, None, :] < length
    w = torch.softmax(_cap_and_mask(scores, valid, softcap, after_mask), -1)
    return torch.einsum("bht,bhtd->bhd", w, vv).to(q.dtype)


def _decode_scores(q, k, length, softcap):
    """[B,H,T] float32 scaled scores of q against k, capped, -inf at and
    past each row's length."""
    b, h, d = q.shape
    t = k.shape[2]
    kk = k.repeat_interleave(h // k.shape[1], dim=1).float()
    scores = torch.einsum("bhd,bhtd->bht", q.float(), kk) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
    valid = torch.arange(t, device=q.device)[None, None, :] < length
    return _cap_and_mask(scores, valid, softcap)


def decode_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length, *,
                             softcap: Optional[float] = None):
    """``decode_attention_ref`` with each (row, head)'s log-sum-exp of
    the capped, scaled scores: (out [B,H,D] in q's dtype, lse [B,H]
    float32).  A row with no valid key gives out 0 and lse -inf (the
    kernel's values).  The partial result of a block of a longer cache,
    merged across blocks by ``decode_merge``."""
    out = _decode_plain(q, k, v, length, softcap)
    empty = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1) <= 0
    lse = torch.logsumexp(_decode_scores(q, k, length, softcap), -1)
    return out.masked_fill(empty, 0), lse


def decode_merge(outs: torch.Tensor, lses: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The decode over a cache cut by length into R blocks, from each
    block's partial result: outs [R,B,H,D] (each block's normalised
    output) and lses [R,B,H] (its log-sum-exp), in float32:
    ``sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M)`` with M the
    largest lse, so a block with no valid key (lse -inf) weighs 0.
    Returns [B,H,D] in ``dtype``."""
    m = lses.amax(0)
    w = torch.exp(lses - torch.where(m == -math.inf, 0.0, m))
    num = (w[..., None] * outs.float()).sum(0)
    return (num / w.sum(0).clamp_min(1e-20)[..., None]).to(dtype)


def decode_merge_faults(q: torch.Tensor, ks, outs: torch.Tensor,
                        lses: torch.Tensor, lengths, *,
                        softcap: Optional[float] = None):
    """Two wrong merges of ``decode_merge``, which a check of the merge
    must reject wherever the blocks' weights differ: ``"log l without
    m"``, each block's log-sum-exp without its running max (a kernel
    that wrote log l alone), and ``"blocks averaged"``, the mean of the
    non-empty blocks' outputs.  ks: each block's keys [B,Hkv,T_r,D] and
    lengths its valid rows, the inputs of outs / lses.  Returns {name:
    [B,H,D] in q's dtype}."""
    m = torch.stack([_decode_scores(q, k, n, softcap).amax(-1)
                     for k, n in zip(ks, lengths)])
    live = (lses > -math.inf).float()
    no_m = torch.where(live > 0, lses - m, -math.inf)
    mean = (outs.float() * live[..., None]).sum(0) / \
        live.sum(0).clamp_min(1)[..., None]
    return {"log l without m": decode_merge(outs, no_m, q.dtype),
            "blocks averaged": mean.to(q.dtype)}


def decode_attention_faults(q, k, v, length, *, softcap):
    """Wrong versions of ``decode_attention_ref`` with a cap, which the
    checks of the cap must reject: the cap dropped, and the cap applied
    after the mask.  Returns {name: [B,H,D]}."""
    return {"cap dropped": _decode_plain(q, k, v, length, None),
            "cap after the mask": _decode_plain(q, k, v, length, softcap,
                                                after_mask=True)}


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


def _scan_backward(a, h, h0, grad, scan, shift):
    a_next = torch.cat([a[:, shift:], torch.zeros_like(a[:, :shift])], 1) \
        if shift else a
    g = scan(a_next.flip(1), grad.flip(1).contiguous(),
             torch.zeros(h0.shape, dtype=torch.float32,
                         device=a.device)).flip(1)
    h_prev = torch.cat([h0[:, None].to(h.dtype), h[:, :-1]], 1)
    da = (g.float() * h_prev.float()).to(a.dtype)
    dh0 = (a[:, 0].float() * g[:, 0].float()).to(h0.dtype)
    return da, g, dh0


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                        grad: torch.Tensor, scan=rglru_scan_ref):
    """The gradients (da, db, dh0) of ``h = scan(a, b, h0)`` given
    ``grad`` = dL/dh [B,S,W], from a and h alone.  The adjoint
    ``g_t = grad_t + a_{t+1} g_{t+1}`` is the same recurrence run
    backwards in time, so it is ``scan`` itself on the flipped sequences
    of a shifted one step (0 past the end) and ``grad``, from a zero
    state; then ``db = g``, ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``) and
    ``dh0 = a_0 g_0``.  ``scan`` is the plain version here and the CUDA
    kernel in ``kernels/rglru_scan.py``'s autograd function."""
    return _scan_backward(a, h, h0, grad, scan, 1)


def rglru_scan_backward_unshifted(a, h, h0, grad, scan=rglru_scan_ref):
    """A wrong ``rglru_scan_backward`` (a planted fault for checks that
    must be able to fail): the adjoint scanned with ``a_t`` where
    ``a_{t+1}`` belongs."""
    return _scan_backward(a, h, h0, grad, scan, 0)


def decode_split_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, length, chunk: int, *,
                          tile: int = 64, softcap: Optional[float] = None):
    """The split-KV decode kernel's partials in plain torch (a model for
    tests and ``chip_smoke.py``, not a path of ``ops``): the cache axis
    cut into splits of ``chunk`` keys (``decode_attention.plan``'s cut:
    whole tiles); each split folds its keys below ``length`` in tiles of
    ``tile`` into an online softmax in float32 (P rounded to q's dtype
    before P V, as the bf16 kernel feeds the tensor cores), the scores
    capped first under ``softcap``.  Returns the running max m and sum l
    [B,H,splits] and the unnormalised acc [B,H,splits,D]; a split with
    no valid key has m = -inf, l = 0."""
    b, h, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    qf = q.float() / math.sqrt(d)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    length = torch.as_tensor(length, device=q.device).reshape(-1)
    length = length.expand(b).clamp(0, t)
    parts = []
    for lo in range(0, max(t, 1), chunk):
        m = torch.full((b, h), -math.inf, device=q.device)
        l = torch.zeros((b, h), device=q.device)
        acc = torch.zeros((b, h, d), device=q.device)
        for k0 in range(lo, min(lo + chunk, t), tile):
            k1 = min(k0 + tile, lo + chunk, t)
            s = cap_scores(torch.einsum("bhd,bhtd->bht", qf,
                                        kk[:, :, k0:k1]), softcap)
            valid = torch.arange(k0, k1, device=q.device)[None, None] < \
                length[:, None, None]
            s = s.masked_fill(~valid, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            mu = torch.where(m_new == -math.inf, 0.0, m_new)
            p = torch.exp(s - mu[..., None])
            alpha = torch.exp(m - mu)
            l = l * alpha + p.sum(-1)
            pv = p.to(q.dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bht,bhtd->bhd", pv, vv[:, :, k0:k1])
            m = m_new
        parts.append((m, l, acc))
    return (torch.stack([m for m, _, _ in parts], -1),
            torch.stack([l for _, l, _ in parts], -1),
            torch.stack([acc for _, _, acc in parts], -2))


def decode_split_combine(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
    """The kernel's combine of ``decode_split_partials``, split by split
    in order: ``sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M),
    1e-20)`` with M the largest m, so a row with no valid key gives 0
    (the Pallas kernel's value).  Returns [B,H,D] in ``dtype``."""
    mm = m.amax(-1)
    mu = torch.where(mm == -math.inf, 0.0, mm)
    num = torch.zeros(acc.shape[:2] + acc.shape[3:], device=acc.device)
    den = torch.zeros(m.shape[:2], device=acc.device)
    for s in range(m.shape[-1]):
        f = torch.where(m[..., s] == -math.inf, 0.0,
                        torch.exp(m[..., s] - mu))
        num = num + acc[:, :, s] * f[..., None]
        den = den + l[..., s] * f
    return (num / den.clamp_min(1e-20)[..., None]).to(dtype)


def decode_split_faults(m: torch.Tensor, l: torch.Tensor,
                        acc: torch.Tensor, dtype: torch.dtype):
    """Two wrong combines of ``decode_split_partials``, to show that a
    check can see the combine (it must reject both wherever a row spans
    splits of different weight): ``"equal weights"``, the mean of the
    non-empty splits' acc / l, and ``"no rescale"``, sum acc / sum l with
    each split left on its own max.  Returns {name: [B,H,D] in dtype}."""
    live = (l > 0).float()
    part = acc / l.clamp_min(1e-20)[..., None]
    equal = (part * live[..., None]).sum(2) / \
        live.sum(2).clamp_min(1)[..., None]
    own = acc.sum(2) / l.sum(2).clamp_min(1e-20)[..., None]
    return {"equal weights": equal.to(dtype), "no rescale": own.to(dtype)}


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, length, chunk: int, *,
                               tile: int = 64,
                               softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """The split-KV decode kernel's algorithm in plain torch: the
    partials of splits of ``chunk`` keys, combined in split order."""
    return decode_split_combine(
        *decode_split_partials(q, k, v, length, chunk, tile=tile,
                               softcap=softcap), q.dtype)


def rglru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor,
                           h0: torch.Tensor, ct: int, *,
                           window: int = 16) -> torch.Tensor:
    """The chunked scan kernel's algorithm in plain torch (a model for
    tests, not a path of ``ops``): chunks of ``ct``
    steps; each chunk's aggregate (A = prod a_t, B = the scan from 0);
    chunk c's carry from h0 (c <= ``window``) or from the last h of chunk
    c - window - 1, then the aggregates of the chunks between folded in
    order (h = A_j h + B_j); the chunk's last state A_c h + B_c; then the
    chunk rescanned from its carry step by step.  The state is float32;
    h_t is returned in a's dtype."""
    bsz, s, w = a.shape
    af, bf = a.float(), b.float()
    starts = list(range(0, s, ct))
    agg = []
    for t0 in starts:
        aa = torch.ones((bsz, w), device=a.device)
        bb = torch.zeros((bsz, w), device=a.device)
        for t in range(t0, min(t0 + ct, s)):
            aa = aa * af[:, t]
            bb = af[:, t] * bb + bf[:, t]
        agg.append((aa, bb))
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    last = []
    for c, t0 in enumerate(starts):
        lo = max(0, c - window)
        h = last[lo - 1] if lo > 0 else h0.float()
        for aa, bb in agg[lo:c]:
            h = aa * h + bb
        last.append(agg[c][0] * h + agg[c][1])
        for t in range(t0, min(t0 + ct, s)):
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


def counting_sort_positions(keys: torch.Tensor, num: int,
                            tile: int) -> torch.Tensor:
    """Where ``ordered_segment_sum``'s counting sort puts each entry,
    modelled pass by pass as the kernels compute it: per-tile key
    counts; an exclusive scan in (key, tile) order (a key's start plus
    the entries of that key in earlier tiles); then each tile's entries
    in index order, 32 at a time (one warp's lanes), each after the
    earlier entries of its key and ranked among the lower lanes with the
    same key (``__match_any_sync`` and a popcount of the lower lanes),
    after which each key's position moves on by its lanes.  keys: [N]
    int64 in [0, num).  Returns [N] int64 positions in key-major
    order."""
    n = keys.numel()
    dev = keys.device
    tiles = -(-n // tile)
    t_of = torch.arange(n, device=dev) // tile
    counts = torch.zeros(tiles, num, dtype=torch.int64, device=dev)
    counts.index_put_((t_of, keys), torch.ones_like(keys), accumulate=True)
    offs = torch.cumsum(counts, 0) - counts                # per key, by tile
    totals = counts.sum(0)
    starts = torch.cumsum(totals, 0) - totals
    lower = torch.tril(torch.ones(32, 32, dtype=torch.bool, device=dev), -1)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for t in range(tiles):
        pos = starts + offs[t]
        for c0 in range(t * tile, min(n, (t + 1) * tile), 32):
            k = keys[c0:c0 + 32]
            same = k[:, None] == k[None, :]
            rank = (same & lower[:k.numel(), :k.numel()]).sum(1)
            out[c0:c0 + k.numel()] = pos[k] + rank
            pos.index_add_(0, k, torch.ones_like(k))
    return out


def _pairwise_runs(x: torch.Tensor, seg: torch.Tensor):
    """x [C, M] in key-major order, seg [M] its (sorted) keys: each run
    reduced by a pairwise tree ((x0 + x1) + (x2 + x3) ...).  Returns the
    one value per run and the run's key."""
    while seg.numel():
        m = seg.numel()
        idx = torch.arange(m, device=seg.device)
        first = torch.ones(m, dtype=torch.bool, device=seg.device)
        first[1:] = seg[1:] != seg[:-1]
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
        has_next = torch.zeros_like(first)
        has_next[:-1] = ~first[1:]
        even = rank % 2 == 0
        if not bool((even & has_next).any()):
            break
        nxt = torch.zeros_like(x)
        nxt[:, :-1] = x[:, 1:]
        x = torch.where(even & has_next, x + nxt, x)[:, even]
        seg = seg[even]
    return x, seg


def ordered_segment_sum_faults(vals: torch.Tensor, keys: torch.Tensor,
                               num: int):
    """Two wrong orders of ``ordered_segment_sum_ref``, which a check of
    the kernel must reject: each key's run summed in reverse order, and
    each run summed as a pairwise tree.  Returns {name: [C, num]}."""
    rev = ordered_segment_sum_ref(vals.flip(1), keys.flip(0), num)
    order = torch.sort(keys, stable=True).indices
    x, seg = _pairwise_runs(vals[:, order], keys[order])
    pair = torch.zeros(vals.shape[0], num, dtype=vals.dtype,
                       device=vals.device)
    pair[:, seg] = x
    return {"reversed order": rev, "pairwise sum": pair}


def segment_trapz_faults(want: torch.Tensor, tile: int, full_tiles: int):
    """A wrong ``segment_trapz`` a check of the kernel must reject: the
    ring read one tile late, so each ring tile t >= 1 (t < full_tiles)
    holds the outputs of tile t - 1.  want: the right [N] outputs.
    Returns {name: [N]}."""
    late = want.clone()
    end = full_tiles * tile
    if full_tiles > 1:
        late[tile:end] = want[:end - tile]
    return {"ring read one tile late": late}
