"""Attention mixers: GQA/MQA/MHA (full and sliding-window), cross-
attention to an encoder's output, and MLA (multi-head latent attention),
with their caches, in prefill and in decode.

GQA and cross-attention go through the port's kernels (``kernels/ops``):
``flash_attention`` for a prefill at cache offset 0 (with or without a
cache) and for a multi-token step at an offset (chunked prefill, or
several tokens verified at once), ``decode_attention`` for a one-token
step against the cache.  On the card they are the hand-written CUDA
kernels; on the CPU their plain PyTorch versions.  This is the
reference's function (``repro/models/attention.py`` ``gqa_attention``,
which computes it with jnp) within the kernels' tolerances: the kernels
keep the softmax weights in float32 where the reference rounds them to
the value dtype.  ``cfg.attn_logit_softcap`` goes into both kernels,
which cap the scaled scores (``c tanh(s / c)``) before the mask, as the
reference does.

A step at cache offset ``off > 0`` of ``s`` tokens reads back the cache
rows it may see, [lo, off + s) with lo = off + 1 - window under a window
(0 without), through ``_kv_read`` (an int8 cache dequantized): one token
hands them to ``decode_attention``; several to ``flash_attention`` with
``q_offset = off - lo`` (query row i at position off + i, cache row j at
lo + j), causal and windowed.  For several tokens lo is rounded down to a
multiple of 128 rows (the kernel masks the window itself): the chunk then
visits the same key tiles, in the same order, as a one-shot prefill of
the same rows does, so its sums round alike.  Cross-attention (``kv_override``: the
encoder's K/V, all of them valid) ropes no query and masks nothing: a
prefill, or a step of several tokens, is a non-causal
``flash_attention`` of the S queries against the T encoder rows, a
one-token step a ``decode_attention`` over all T rows.

MLA is the reference's plain computation (it reaches no Pallas kernel):
the naive path (per-head K/V materialized from the latent) for prefill,
the absorbed path (scores and outputs in the compressed ``kv_lora``
space, against the ``c_kv`` / ``k_rope`` cache) for decode.  Its scores
are float32 from float32 copies of the operands (the reference's
``preferred_element_type``), and mixed dtypes are cast as jax promotes
them.

The GQA KV cache is ``[B, T, Hkv, D]`` per layer (float32, bfloat16 or
int8 with per-(token, head) scales), the MLA cache ``c_kv [B, T, kvr]``
and ``k_rope [B, T, qr]``.  Writes are out of place
(``torch.slice_scatter``), as the reference's ``dynamic_update_slice``:
the serving engine merges only the rows it stepped.

In the sharded serving body (``tp``, a ``sharding.ServeShards``, with a
cache: ``_serve_attention``) each rank holds the block [lo, hi) of the
cache's length and writes its rows of K/V into it in place
(``_kv_put``; the reference donates the cache).  A prefill runs the
rank's query heads (all of them where the heads replicate) over the
whole sequence of its rows; a decode step runs every head over the rows
of its block the token may see, with their log-sum-exp, and merges the
ranks' partials (``ServeShards.merge``) before its share of ``wo``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import spec

Tree = Any

# rows a multi-token step's cache view starts on a multiple of: the key
# tile of every flash kernel (128, 64, 32 or 16 keys) divides it
KEY_ALIGN = 128


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, K] (K even), positions: [..., S].
    Frequencies and angles are float32, computed in the reference's
    order (``theta ** (-i / half)``)."""
    k = x.shape[-1]
    half = k // 2
    freq_exp = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = torch.tensor(theta, dtype=torch.float32,
                            device=x.device) ** (-freq_exp)
    ang = positions[..., :, None].to(torch.float32) * inv_freq  # [...,S,half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    sin = sin[..., :, None, :]          # broadcast over heads
    cos = cos[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ArchConfig) -> Tree:
    """GQA projections (also the cross-attention's, whose K/V read the
    encoder output)."""
    d, hq, hkv, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = cfg.param_dtype
    return {
        "wq": spec([d, hq, k], ["embed", "heads", "hdim"], dt),
        "wk": spec([d, hkv, k], ["embed", "kv_heads", "hdim"], dt),
        "wv": spec([d, hkv, k], ["embed", "kv_heads", "hdim"], dt),
        "wo": spec([hq, k, d], ["heads", "hdim", "embed"], dt),
    }


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, window,
          causal: bool) -> torch.Tensor:
    """[..., S_q, S_k] boolean validity mask from absolute positions (the
    semantics both kernels implement; used by tests as the oracle)."""
    dq = pos_q[..., :, None]
    dk = pos_k[..., None, :]
    m = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                   dtype=torch.bool, device=pos_q.device)
    if causal:
        m = dk <= dq
    if window is not None:
        m = m & (dq - dk < window)
    return m


def gqa_attention(
    p: Tree,
    x: torch.Tensor,                      # [B,S,D]
    positions: torch.Tensor,              # [B,S] absolute positions
    *,
    cfg: ArchConfig,
    window: Optional[int] = None,
    rope_theta: float = 10_000.0,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset=None,                    # int write index (0 if None)
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full/windowed GQA, scores capped by ``cfg.attn_logit_softcap``.
    With a cache: writes K/V at ``cache_offset`` and attends over the
    cache up to the write frontier (a step of any length at any offset).
    With ``kv_override`` (cross-attention: the encoder's K/V
    [B, T, Hkv, D]): q is not roped, every key is visible, and ``cache``
    is passed through; ``cache_offset`` only says prefill (0) or decode
    step.  ``tp`` (a ``sharding.ModelShards``): without a cache the
    sharded train body, ``x`` this rank's sequence block
    (``_tp_attention``); with one the sharded serving body
    (``_serve_attention``)."""
    b, s, _ = x.shape
    off = 0 if cache_offset is None else int(cache_offset)
    softcap = cfg.attn_logit_softcap
    if tp is not None:
        if kv_override is not None:
            raise ValueError("the sharded bodies run no cross-attention")
        if cache is not None:
            return _serve_attention(p, x, positions, cfg=cfg, window=window,
                                    rope_theta=rope_theta, causal=causal,
                                    cache=cache, off=off, tp=tp)
        return _tp_attention(p, x, positions, cfg=cfg, window=window,
                             rope_theta=rope_theta, causal=causal,
                             tp=tp), None
    if off > 0 and cache is None and kv_override is None:
        raise ValueError("a decode step at a nonzero offset needs a cache")

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv_override is not None:
        k, v = kv_override
        return _attend(p, q, k.to(q.dtype), v.to(q.dtype), off,
                       causal=False, window=None, softcap=softcap), cache
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    new_cache = None
    q_offset = 0
    if cache is not None:
        t = cache["k"].shape[1]
        new_cache = dict(cache)
        new_cache.update(_kv_write(cache, "k", k, off))
        new_cache.update(_kv_write(cache, "v", v, off))
        if off > 0:
            # a step: only the rows its queries may see, [lo, off + s)
            # (the first query, at ``off``, sees none before lo); query
            # row i sits at position off + i, cache row j of the view at
            # lo + j
            lo = 0 if window is None else max(0, off + 1 - window)
            if s > 1:
                lo -= lo % KEY_ALIGN
            rows = {n: c[:, lo:off + s] for n, c in new_cache.items()}
            k = _kv_read(rows, "k", q.dtype)
            v = _kv_read(rows, "v", q.dtype)
            q_offset = off - lo
        elif s != t:
            # prefill into a longer cache: read it back; rows past the
            # frontier are masked by causality
            k = _kv_read(new_cache, "k", q.dtype)
            v = _kv_read(new_cache, "v", q.dtype)
    return _attend(p, q, k.to(q.dtype), v.to(q.dtype), off,
                   causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset), new_cache


def _kv_for_heads(kv: Tuple[torch.Tensor, torch.Tensor], hl: int,
                  cfg: ArchConfig, tp, dim: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K / V heads (along ``dim`` of each of ``kv``) that this rank's
    ``hl`` query heads read.  Every head here, or the K/V heads split
    with the query heads: its own.  K/V heads replicated under split
    query heads: only the ones its heads read, one each where a group of
    them shares one (else one a query head, so the kernel's head
    grouping holds)."""
    if hl == cfg.n_heads or kv[0].shape[dim] < cfg.n_kv_heads:
        return kv
    group = cfg.n_heads // cfg.n_kv_heads
    used = [(tp.index * hl + i) // group for i in range(hl)]
    first, n = used[0], used[-1] - used[0] + 1
    if hl % n == 0 and used == [first + i // (hl // n) for i in range(hl)]:
        return tuple(t.narrow(dim, first, n) for t in kv)
    idx = torch.tensor(used, device=kv[0].device)
    return tuple(t.index_select(dim, idx) for t in kv)


def _tp_kv(p: Tree, cfg: ArchConfig, tp) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The K / V projections (FSDP-gathered) this rank's query heads use
    (``_kv_for_heads`` of ``wk`` / ``wv``)."""
    return _kv_for_heads((p["wk"], p["wv"]), p["wq"].shape[1], cfg, tp, 1)


def _tp_attention(p: Tree, x: torch.Tensor, positions: torch.Tensor, *,
                  cfg: ArchConfig, window: Optional[int], rope_theta,
                  causal: bool, tp) -> torch.Tensor:
    """Attention in the sharded train body: ``x`` [B, S / size, D] is
    this rank's sequence block, ``positions`` [B, S] the whole
    sequence's (the window and the rope angle are of the global row).
    The sequence is gathered before the projections.  Query heads split
    over the model axis: this rank's heads over the whole sequence, the
    row-parallel ``wo``'s partial sums reduce-scattered back to its
    block.  Heads replicated (they do not divide the axis): every rank
    runs all of them and keeps its own rows, GSPMD's redundancy for such
    a dim.  ``flash_attention`` gets [B, local heads, S, D] views."""
    h = tp.seq_gather(x)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    wk, wv = _tp_kv(p, cfg, tp)
    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    softcap = cfg.attn_logit_softcap
    if p["wq"].shape[1] == cfg.n_heads:
        return _attend(p, q, k, v, 0, causal=causal, window=window,
                       softcap=softcap, rows=tp.rows(h.shape[1]))
    return tp.seq_scatter(_attend(p, q, k, v, 0, causal=causal,
                                  window=window, softcap=softcap))


def _serve_attention(p: Tree, x: torch.Tensor, positions: torch.Tensor, *,
                     cfg: ArchConfig, window: Optional[int], rope_theta,
                     causal: bool, cache: Dict[str, torch.Tensor], off: int,
                     tp) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention in the sharded serving body (module docstring): ``x``
    [B, S, D] this rank's rows, replicated over the model axis; ``cache``
    its block [lo, hi) of the length, written in place (``_kv_put``).
    ``p``'s K/V projections are whole (``ServeShards.layer``), its query
    and output projections the rank's heads, or whole where the heads
    replicate.  A prefill (``off`` 0) runs the rank's heads over the
    sequence through ``flash_attention``; a one-token step every head
    over the block's visible rows, [lo, hi) within [pos + 1 - window,
    pos], through ``decode_attention`` with the log-sum-exp (a block the
    token cannot see: a one-row view at length 0, weighing 0), merged
    over the axis.  Split heads end in an all-reduce of ``wo``'s partial
    sums.  At an axis of size 1 the step is ``_attend``'s, op for op."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    length = cache["k"].shape[1] * tp.size
    if off + s > length:
        raise ValueError(f"cache write of {s} rows at {off} overruns "
                         f"{length} rows")
    lo, hi = tp.rows(length)
    cache = _kv_put(cache, {"k": k, "v": v}, lo, off)
    hl = q.shape[2]
    split = hl != cfg.n_heads
    softcap = cfg.attn_logit_softcap
    if off == 0:
        k, v = _kv_for_heads((k, v), hl, cfg, tp, 2)
        y = _attend(p, q, k, v, 0, causal=causal, window=window,
                    softcap=softcap)
        return (tp.seq_scatter(y) if split else y), cache
    if s != 1:
        raise ValueError("the sharded serving body steps one token at a "
                         "time")
    first = 0 if window is None else max(0, off + 1 - window)
    a, n = max(lo, first), min(hi, off + 1) - max(lo, first)
    start = min(a, hi - 1) - lo
    rows = {nm: c[:, start:start + max(n, 1)] for nm, c in cache.items()}
    k, v = _kv_read(rows, "k", q.dtype), _kv_read(rows, "v", q.dtype)
    if tp.size == 1:
        return _attend(p, q, k, v, off, causal=causal, window=window,
                       softcap=softcap), cache
    kw = {} if softcap is None else {"softcap": softcap}
    q = tp.concat(q[:, 0], 1) if split else q[:, 0]
    out, lse = ops.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                    max(n, 0), lse=True, **kw)
    out = tp.merge(out, lse)
    if split:
        out = out.narrow(1, tp.index * hl, hl)
    y = torch.einsum("bshk,hkd->bsd", out[:, None], p["wo"])
    return (tp.seq_scatter(y) if split else y), cache


def _kv_put(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor],
            lo: int, off: int) -> Dict[str, torch.Tensor]:
    """Write K and V ([B, S, Hkv, D], at positions off .. off + S - 1)
    into a cache block holding positions [lo, lo + T) of the length, in
    place: the rows that fall inside it, cast to its float dtype (the
    sharded serving body; the reference donates the cache).  Returns
    ``cache`` itself."""
    t, s = cache["k"].shape[1], kv["k"].shape[1]
    if cache["k"].dtype == torch.int8:
        raise ValueError("the sharded serving body writes float caches")
    a, e = max(lo, off), min(lo + t, off + s)
    for name, val in kv.items():
        if e > a:
            cache[name][:, a - lo:e - lo].copy_(val[:, a - off:e - off])
    return cache


def _attend(p: Tree, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            off: int, *, causal: bool, window: Optional[int],
            softcap: Optional[float] = None,
            q_offset: int = 0,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """q [B,S,H,D] against k, v [B,T,Hkv,D] through the kernels, then the
    output projection: a prefill (``off`` 0), or a step of several
    tokens (query row i at position ``q_offset + i`` of the T rows), by
    ``flash_attention``; a one-token step by ``decode_attention`` over
    all T rows (the cache rows the step may see, or the encoder's).  The
    kernels take [B, heads, seq, D] views of the [B, seq, heads, D]
    activations and cache, by strides, with no copy.  ``softcap`` and a
    nonzero ``q_offset`` are passed only when set.  ``rows`` [lo, hi):
    only those query rows go through the output projection."""
    b, s = q.shape[:2]
    kw = {} if softcap is None else {"softcap": softcap}
    if off == 0 or s > 1:
        if q_offset:
            kw["q_offset"] = q_offset
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, **kw).transpose(1, 2)
    else:
        length = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=q.device)
        out = ops.decode_attention(q[:, 0], k.transpose(1, 2),
                                   v.transpose(1, 2), length,
                                   **kw)[:, None]
    if rows is not None:
        out = out[:, rows[0]:rows[1]]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _kv_write(cache: dict, name: str, val: torch.Tensor, off: int) -> dict:
    """Write K or V ([B,S,Hkv,D]) into the cache at ``off``, out of place,
    quantizing per (token, head) when the buffer is int8 (scales stored
    alongside as ``<name>_scale``)."""
    buf = cache[name]
    s = val.shape[1]
    if off + s > buf.shape[1]:
        raise ValueError(f"cache write of {s} rows at {off} overruns "
                         f"{buf.shape[1]} rows")
    out = {}
    if buf.dtype == torch.int8:
        vf = val.to(torch.float32)
        amax = vf.abs().amax(dim=-1, keepdim=True)            # [B,S,H,1]
        scale = amax.clamp_min(1e-6) / 127.0
        q = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
        out[name] = torch.slice_scatter(buf, q, 1, off, off + s)
        sc = cache[f"{name}_scale"]
        out[f"{name}_scale"] = torch.slice_scatter(
            sc, scale[..., 0].to(sc.dtype), 1, off, off + s)
    else:
        out[name] = torch.slice_scatter(buf, val.to(buf.dtype), 1, off,
                                        off + s)
    return out


def _kv_read(cache: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    buf = cache[name]
    if buf.dtype == torch.int8:
        scale = cache[f"{name}_scale"].to(torch.float32)[..., None]
        return (buf.to(torch.float32) * scale).to(dtype)
    return buf.to(dtype)


def gqa_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Tree:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    c = {
        "k": spec([batch, max_len, hkv, hd],
                  ["batch", "kv_len", "kv_heads", "hdim"], dtype, "zeros"),
        "v": spec([batch, max_len, hkv, hd],
                  ["batch", "kv_len", "kv_heads", "hdim"], dtype, "zeros"),
    }
    if dtype == torch.int8:
        # per-(token, head) symmetric quantization scales (1/head_dim the
        # footprint of the int8 payload)
        for nm in ("k", "v"):
            c[f"{nm}_scale"] = spec(
                [batch, max_len, hkv],
                ["batch", "kv_len", "kv_heads"], torch.bfloat16, "ones")
    return c


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) -- DeepSeek-V2 / MiniCPM3
# ---------------------------------------------------------------------------

def mla_specs(cfg: ArchConfig) -> Tree:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.param_dtype
    qk = m.qk_nope_head_dim
    qr = m.qk_rope_head_dim
    return {
        "wq_a": spec([d, m.q_lora_rank], ["embed", "lora"], dt),
        "q_norm": spec([m.q_lora_rank], ["lora"], torch.float32, "ones"),
        "wq_b": spec([m.q_lora_rank, h, qk + qr], ["lora", "heads", "hdim"],
                     dt),
        "wkv_a": spec([d, m.kv_lora_rank + qr], ["embed", "lora"], dt),
        "kv_norm": spec([m.kv_lora_rank], ["lora"], torch.float32, "ones"),
        "wk_b": spec([m.kv_lora_rank, h, qk], ["lora", "heads", "hdim"], dt),
        "wv_b": spec([m.kv_lora_rank, h, m.v_head_dim],
                     ["lora", "heads", "hdim"], dt),
        "wo": spec([h, m.v_head_dim, d], ["heads", "hdim", "embed"], dt),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the latents with a float32 scale, in float32."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def mla_project(p: Tree, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, rope_theta) -> Tuple[torch.Tensor, ...]:
    """Shared projections: q_nope [B,S,H,qk], q_rope [B,S,H,qr],
    c_kv [B,S,kvr], k_rope [B,S,qr] (one rope head shared by all
    heads)."""
    m = cfg.mla
    qk = m.qk_nope_head_dim
    q_lat = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    q_lat = _rms(q_lat, p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    q_rope = rope(q_rope, positions, rope_theta)

    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = _rms(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _softmax_masked(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """softmax over the last axis of float32 ``scores`` [B,H,S,T] where
    ``mask`` [B,S,T] holds, the rest at float32's lowest (as the
    reference: a row with no valid key is uniform, not NaN)."""
    low = torch.finfo(scores.dtype).min
    return torch.softmax(scores.masked_fill(~mask[:, None], low), -1)


def mla_attention_naive(
    p: Tree, x: torch.Tensor, positions: torch.Tensor, *, cfg: ArchConfig,
    rope_theta=10_000.0, cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Prefill path: per-head K/V materialized from the latent, causal
    over ``positions``.  With a cache, also writes ``c_kv`` / ``k_rope``
    at offset 0 from the same projections (the reference projects
    twice)."""
    q_nope, q_rope, c_kv, k_rope = mla_project(p, x, positions, cfg,
                                               rope_theta)
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["wk_b"])
    v = torch.einsum("btr,rhk->bthk", c_kv, p["wv_b"])
    # float32 scores from float32 operands: bf16 products are exact there
    scores = (torch.einsum("bshk,bthk->bhst", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.float())) * _mla_scale(cfg)
    w = _softmax_masked(scores, _mask(positions, positions, None, True))
    out = torch.einsum("bhst,bthk->bshk", w.to(v.dtype), v)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    new_cache = None
    if cache is not None:
        new_cache = {n: torch.slice_scatter(cache[n], val.to(cache[n].dtype),
                                            1, 0, val.shape[1])
                     for n, val in (("c_kv", c_kv), ("k_rope", k_rope))}
    return y, new_cache


def mla_attention_absorbed(
    p: Tree, x: torch.Tensor, positions: torch.Tensor, *, cfg: ArchConfig,
    cache: Dict[str, torch.Tensor], cache_offset, rope_theta=10_000.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode path: scores and outputs against the compressed cache.

    q_c = q_nope @ wk_b (absorbed): [B,S,H,kvr]; scores = q_c . c_kv +
    q_rope . k_rope; out = (attn @ c_kv) @ wv_b.  Writes the S new rows
    at ``cache_offset`` and masks keys past a query's position or past
    the write frontier, over the whole cache (a multi-token step at a
    nonzero offset is legal).  Casts follow jax's promotion: with a
    float32 cache, the context and the value absorption are float32,
    cast to x's dtype before ``wo``."""
    s = x.shape[1]
    off = int(cache_offset)
    q_nope, q_rope, c_kv_new, k_rope_new = mla_project(
        p, x, positions, cfg, rope_theta)
    t = cache["c_kv"].shape[1]
    if off + s > t:
        raise ValueError(f"cache write of {s} rows at {off} overruns {t} "
                         f"rows")
    c_kv = torch.slice_scatter(cache["c_kv"],
                               c_kv_new.to(cache["c_kv"].dtype), 1, off,
                               off + s)
    k_rope = torch.slice_scatter(cache["k_rope"],
                                 k_rope_new.to(cache["k_rope"].dtype), 1,
                                 off, off + s)
    new_cache = {"c_kv": c_kv, "k_rope": k_rope}

    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])   # absorbed
    scores = (torch.einsum("bshr,btr->bhst", q_c.float(),
                           c_kv.to(q_c.dtype).float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.to(q_rope.dtype).float())) * \
        _mla_scale(cfg)
    pos_k = torch.arange(t, device=x.device)[None, :]
    mask = _mask(positions, pos_k, None, True) & \
        (pos_k <= off + s - 1)[:, None, :]
    w = _softmax_masked(scores, mask)
    ctx = torch.einsum("bhst,btr->bshr", w.to(c_kv.dtype), c_kv)
    # jax promotes ctx @ wv_b to the wider of the two dtypes
    wide = torch.promote_types(ctx.dtype, p["wv_b"].dtype)
    out = torch.einsum("bshr,rhk->bshk", ctx.to(wide), p["wv_b"].to(wide))
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, new_cache


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Tree:
    m = cfg.mla
    return {
        "c_kv": spec([batch, max_len, m.kv_lora_rank],
                     ["batch", "kv_len", "lora"], dtype, "zeros"),
        "k_rope": spec([batch, max_len, m.qk_rope_head_dim],
                       ["batch", "kv_len", "hdim"], dtype, "zeros"),
    }
