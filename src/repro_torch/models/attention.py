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
the naive path (per-head K/V materialized from the latent) for training
and prefill, query-chunked as the reference's (``chunk_q``, the
``RunFlags.attn_chunk`` of 1,024: a chunk's [B, H, chunk_q, S] scores
are the working set), the absorbed path (scores and outputs in the
compressed ``kv_lora`` space, against the ``c_kv`` / ``k_rope`` cache)
for decode.  Its scores are float32 from float32 copies of the operands
(the reference's ``preferred_element_type``), and mixed dtypes are cast
as jax promotes them.

The GQA KV cache is ``[B, T, Hkv, D]`` per layer (float32, bfloat16 or
int8 with per-(token, head) scales), the MLA cache ``c_kv [B, T, kvr]``
and ``k_rope [B, T, qr]``.  Writes are out of place
(``torch.slice_scatter``), as the reference's ``dynamic_update_slice``
(the serving engine merges only the rows it stepped); the sharded
serving body writes in place (below).

In the sharded serving body (``tp``, a ``sharding.ServeShards``, with a
cache: ``_serve_attention``) each rank holds the block [lo, hi) of the
cache's length and writes its rows of K/V into it in place
(``_kv_put``; the reference donates the cache).  A prefill runs the
rank's query heads (all of them where the heads replicate) over the
whole sequence of its rows; a decode step runs every head over the rows
of its block the token may see, with their log-sum-exp, and merges the
ranks' partials (``ServeShards.merge``) before its share of ``wo``.
MLA does the same (``_serve_mla``, the latent rows written by
``_kv_put``): its prefill runs the rank's heads, its decode every
head's absorbed query against the block, each block's float32 latent
context merged by its log-sum-exp (a block with no row to see weighs
0) before the rank's heads take it through ``wv_b`` and ``wo``.  In the
sharded train body (without a cache) MLA runs the rank's heads over the
gathered sequence (``_tp_mla``), as ``_tp_attention`` does; where its
heads replicate (minicpm3-4b's 40 on 16 ranks) every head runs the
queries of the rank's own rows against the gathered latents.  A
cross-attention whose heads and frames split over no "model" rank
(whisper-base's) runs every head of the rank's rows against all the
frames: in train with no collective, in serving from a cache split by
head dim, written in place and gathered whole a layer at a decode step
(``serve_cross_attention``).
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
    (``_tp_attention``; a cross-attention: its rows against every frame,
    below); with one the sharded serving body (``_serve_attention``; its
    cross-attention is ``serve_cross_attention``)."""
    b, s, _ = x.shape
    off = 0 if cache_offset is None else int(cache_offset)
    softcap = cfg.attn_logit_softcap
    if tp is not None and kv_override is not None:
        # the train body's cross-attention: this rank's rows (its
        # sequence block) against all T frames of the encoder output,
        # which every model rank holds, every head (the weights whole):
        # the computation below, with no collective.  Each rank's
        # gradient of the frames is its rows' part; ``reduce_grads`` sums
        # the encoder's replicated leaves' over the axis
        if cache is not None or p["wq"].shape[1] != cfg.n_heads:
            raise ValueError("the sharded train body's cross-attention "
                             "runs every head, without a cache")
    elif tp is not None:
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
    a dim.  A residual replicated over the axis (an encoder's frames,
    ``tp.replicated``) is the whole sequence and keeps every row.
    ``flash_attention`` gets [B, local heads, S, D] views."""
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
                       softcap=softcap, rows=tp.seq_rows(h.shape[1]))
    return tp.seq_scatter(_attend(p, q, k, v, 0, causal=causal,
                                  window=window, softcap=softcap))


def _serve_attention(p: Tree, x: torch.Tensor, positions: torch.Tensor, *,
                     cfg: ArchConfig, window: Optional[int], rope_theta,
                     causal: bool, cache: Dict[str, torch.Tensor], off: int,
                     tp) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention in the sharded serving body (module docstring): ``x``
    [B, S, D] this rank's rows, replicated over the model axis; ``cache``
    its block [lo, hi) of the length (``tp.kv_rows``: the length is split
    over ``tp.kv_axes``, which may be more axes than the heads' one),
    written in place (``_kv_put``).  ``p``'s K/V projections are whole
    (``ServeShards.layer``), its query and output projections the rank's
    heads, or whole where the heads replicate.  A prefill (``off`` 0)
    runs the rank's heads over the sequence through ``flash_attention``;
    a one-token step every head over the block's visible rows, [lo, hi)
    within [pos + 1 - window, pos], through ``decode_attention`` with the
    log-sum-exp (a block the token cannot see: a one-row view at length
    0, weighing 0), merged over the length axes.  Split heads end in an
    all-reduce of ``wo``'s partial sums over the heads' axis.  With the
    length in one block the step is ``_attend``'s, op for op."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    length = cache["k"].shape[1] * tp.kv_size
    if off + s > length:
        raise ValueError(f"cache write of {s} rows at {off} overruns "
                         f"{length} rows")
    lo, hi = tp.kv_rows(length)
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
    if tp.kv_size == 1:
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


def serve_cross_attention(p: Tree, x: torch.Tensor,
                          kv: Tuple[torch.Tensor, torch.Tensor], *,
                          cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                          off: int, tp) -> Tuple[torch.Tensor,
                                                 Dict[str, torch.Tensor]]:
    """Cross-attention in the sharded serving body: ``x`` [B, S, D] this
    rank's rows, replicated over the model axis, every head (the
    projections whole: ``ServeShards.layer``); ``cache`` {"ek", "ev"}
    [B, T, Hkv, D / n], the rank's block of the head dim of the encoder's
    K/V (its T frames and its K/V heads split over no axis).  A prefill
    (``off`` 0; ``kv`` the encoder's K/V from the whole ``wk`` / ``wv``)
    writes the rank's head-dim block into the cache in place
    (``ServeShards.dim_block``) and runs the non-causal flash of the S
    queries against the T frames; a decode step (``kv`` the cache) gathers
    the head dim whole over the axis for the layer
    (``ServeShards.dim_whole``) and runs one ``decode_attention`` over
    all T frames for every head.  Unsharded ``gqa_attention``'s
    ``kv_override`` path, op for op, where the head dim is whole.
    Returns (y, ``cache`` itself)."""
    ek, ev = kv
    d = cfg.head_dim_
    if off == 0:
        for name, val in (("ek", ek), ("ev", ev)):
            c = cache[name]
            c.copy_(tp.dim_block(val, c.shape[-1]))
    else:
        ek, ev = tp.dim_whole(ek, d), tp.dim_whole(ev, d)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    return _attend(p, q, ek.to(q.dtype), ev.to(q.dtype), off, causal=False,
                   window=None, softcap=cfg.attn_logit_softcap), cache


def _kv_put(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor],
            lo: int, off: int) -> Dict[str, torch.Tensor]:
    """Write the rows of ``kv`` ({name: [B, S, ...]} at positions off ..
    off + S - 1: attention's K and V, or MLA's latent ``c_kv`` and
    ``k_rope``) into a cache block holding positions [lo, lo + T) of the
    length, in place: the rows that fall inside it, cast to its float
    dtype (the sharded serving body; the reference donates the cache).
    Returns ``cache`` itself."""
    first = next(iter(kv))
    t, s = cache[first].shape[1], kv[first].shape[1]
    if any(cache[name].dtype == torch.int8 for name in kv):
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


def _mla_scores(q_nope: torch.Tensor, q_rope: torch.Tensor,
                k_nope: torch.Tensor, k_rope: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """[B,H,S,T] float32 scaled scores of queries [B,S,H,*] against keys
    k_nope [B,T,H,*] (or the latent [B,T,kvr] against absorbed queries)
    and k_rope [B,T,qr]: float32 products of float32 copies of the
    operands (the reference's ``preferred_element_type``; bf16 products
    are exact there)."""
    eq = "bshk,bthk->bhst" if k_nope.dim() == 4 else "bshk,btk->bhst"
    return (torch.einsum(eq, q_nope.float(), k_nope.float())
            + torch.einsum("bshk,btk->bhst", q_rope.float(),
                           k_rope.float())) * _mla_scale(cfg)


def _mla_heads(p: Tree, q_nope: torch.Tensor, q_rope: torch.Tensor,
               c_kv: torch.Tensor, k_rope: torch.Tensor,
               pos_q: torch.Tensor, pos_k: torch.Tensor, cfg: ArchConfig,
               chunk_q: int) -> torch.Tensor:
    """The naive path's attention of the heads ``p`` holds: per-head K/V
    from the latent, the queries at ``pos_q`` [B,S] causal over the keys
    at ``pos_k`` [B,T] (the same positions, or a block of the queries'
    rows against the whole sequence), [B,S,H,v] before ``wo``.
    Query-chunked as the reference: whole when ``s <= chunk_q`` or
    ``chunk_q`` does not divide S, else ``chunk_q`` query rows at a time
    against every key, so a chunk's [B,H,chunk_q,T] float32 scores are
    the working set."""
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["wk_b"])
    v = torch.einsum("btr,rhk->bthk", c_kv, p["wv_b"])
    k_nope, k_rope = k_nope.float(), k_rope.float()

    def attend(lo: int, hi: int) -> torch.Tensor:
        scores = _mla_scores(q_nope[:, lo:hi], q_rope[:, lo:hi], k_nope,
                             k_rope, cfg)
        w = _softmax_masked(scores, _mask(pos_q[:, lo:hi], pos_k, None,
                                          True))
        return torch.einsum("bhst,bthk->bshk", w.to(v.dtype), v)

    s = q_nope.shape[1]
    if s <= chunk_q or s % chunk_q != 0:
        return attend(0, s)
    return torch.cat([attend(i, i + chunk_q) for i in range(0, s, chunk_q)],
                     1)


def mla_attention_naive(
    p: Tree, x: torch.Tensor, positions: torch.Tensor, *, cfg: ArchConfig,
    rope_theta=10_000.0, cache: Optional[Dict[str, torch.Tensor]] = None,
    chunk_q: int = 1024, tp=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Prefill and train path: per-head K/V materialized from the
    latent, causal over ``positions``, query-chunked by ``chunk_q``
    (``_mla_heads``).  With a cache, also writes ``c_kv`` / ``k_rope``
    at offset 0 from the same projections (the reference projects
    twice).  ``tp`` (a ``sharding.ModelShards``): without a cache the
    sharded train body (``_tp_mla``), with one the sharded serving body
    (``_serve_mla``)."""
    if tp is not None:
        if cache is not None:
            return _serve_mla(p, x, positions, cfg=cfg, rope_theta=rope_theta,
                              cache=cache, off=0, chunk_q=chunk_q, tp=tp)
        return _tp_mla(p, x, positions, cfg=cfg, rope_theta=rope_theta,
                       chunk_q=chunk_q, tp=tp), None
    q_nope, q_rope, c_kv, k_rope = mla_project(p, x, positions, cfg,
                                               rope_theta)
    out = _mla_heads(p, q_nope, q_rope, c_kv, k_rope, positions, positions,
                     cfg, chunk_q)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    new_cache = None
    if cache is not None:
        new_cache = {n: torch.slice_scatter(cache[n], val.to(cache[n].dtype),
                                            1, 0, val.shape[1])
                     for n, val in (("c_kv", c_kv), ("k_rope", k_rope))}
    return y, new_cache


def _mla_absorbed(p: Tree, q_nope: torch.Tensor, q_rope: torch.Tensor,
                  cache: Dict[str, torch.Tensor], positions: torch.Tensor,
                  off: int, cfg: ArchConfig, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The absorbed step of the heads ``p`` holds against the whole
    written ``cache``, keys past a query's position or past the write
    frontier masked: the output [B,S,H,v] in ``dtype``, before ``wo``.
    Casts follow jax's promotion: with a float32 cache, the context and
    the value absorption are float32."""
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s, t = q_nope.shape[1], c_kv.shape[1]
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])   # absorbed
    scores = _mla_scores(q_c, q_rope, c_kv.to(q_c.dtype),
                         k_rope.to(q_rope.dtype), cfg)
    pos_k = torch.arange(t, device=q_c.device)[None, :]
    mask = _mask(positions, pos_k, None, True) & \
        (pos_k <= off + s - 1)[:, None, :]
    w = _softmax_masked(scores, mask)
    ctx = torch.einsum("bhst,btr->bshr", w.to(c_kv.dtype), c_kv)
    return _mla_values(p, ctx, dtype)


def _mla_values(p: Tree, ctx: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """The latent context [B,S,H,kvr] through the heads' ``wv_b``: jax
    promotes ctx @ wv_b to the wider of the two dtypes; the output in
    ``dtype``."""
    wide = torch.promote_types(ctx.dtype, p["wv_b"].dtype)
    out = torch.einsum("bshr,rhk->bshk", ctx.to(wide), p["wv_b"].to(wide))
    return out.to(dtype)


def mla_attention_absorbed(
    p: Tree, x: torch.Tensor, positions: torch.Tensor, *, cfg: ArchConfig,
    cache: Dict[str, torch.Tensor], cache_offset, rope_theta=10_000.0,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode path: scores and outputs against the compressed cache.

    q_c = q_nope @ wk_b (absorbed): [B,S,H,kvr]; scores = q_c . c_kv +
    q_rope . k_rope; out = (attn @ c_kv) @ wv_b.  Writes the S new rows
    at ``cache_offset`` and masks keys past a query's position or past
    the write frontier, over the whole cache (a multi-token step at a
    nonzero offset is legal).  Casts follow jax's promotion: with a
    float32 cache, the context and the value absorption are float32,
    cast to x's dtype before ``wo``.  ``tp`` (a ``sharding.ServeShards``):
    the sharded serving body (``_serve_mla``)."""
    s = x.shape[1]
    off = int(cache_offset)
    if tp is not None:
        return _serve_mla(p, x, positions, cfg=cfg, rope_theta=rope_theta,
                          cache=cache, off=off, tp=tp)
    q_nope, q_rope, c_kv_new, k_rope_new = mla_project(
        p, x, positions, cfg, rope_theta)
    t = cache["c_kv"].shape[1]
    if off + s > t:
        raise ValueError(f"cache write of {s} rows at {off} overruns {t} "
                         f"rows")
    new_cache = {n: torch.slice_scatter(cache[n], val.to(cache[n].dtype), 1,
                                        off, off + s)
                 for n, val in (("c_kv", c_kv_new), ("k_rope", k_rope_new))}
    out = _mla_absorbed(p, q_nope, q_rope, new_cache, positions, off, cfg,
                        x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new_cache


def _tp_mla(p: Tree, x: torch.Tensor, positions: torch.Tensor, *,
            cfg: ArchConfig, rope_theta, chunk_q: int, tp) -> torch.Tensor:
    """MLA in the sharded train body (as ``_tp_attention``): ``x``
    [B, S / size, D] this rank's sequence block, ``positions`` [B, S]
    the whole sequence's.  Heads split (``wq_b``, ``wk_b``, ``wv_b`` and
    ``wo`` by "heads"): the sequence is gathered, projected through the
    whole "lora" weights, the rank's heads attend over it,
    query-chunked, and ``wo``'s partial sums are reduce-scattered back to
    the block.  Heads replicated (every weight whole over the axis): the
    block's own rows are projected at their positions, only their
    latents (``c_kv`` and the roped ``k_rope``, 288 wide at minicpm3-4b
    against the residual's 2,560) are gathered over the axis, and every
    head's queries of the block attend against every key; ``wo`` gives
    the block's rows with no collective.  A replicated leaf's gradient
    is then the rank's queries' part, which ``reduce_grads`` sums."""
    if p["wq_b"].shape[1] != cfg.n_heads:
        h = tp.seq_gather(x)
        q_nope, q_rope, c_kv, k_rope = mla_project(p, h, positions, cfg,
                                                   rope_theta)
        out = _mla_heads(p, q_nope, q_rope, c_kv, k_rope, positions,
                         positions, cfg, chunk_q)
        return tp.seq_scatter(torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    lo, hi = tp.seq_rows(positions.shape[1])
    own = positions[:, lo:hi]
    q_nope, q_rope, c_kv, k_rope = mla_project(p, x, own, cfg, rope_theta)
    r = c_kv.shape[-1]
    latents = tp.seq_gather(torch.cat([c_kv, k_rope], -1))
    out = _mla_heads(p, q_nope, q_rope, latents[..., :r], latents[..., r:],
                     own, positions, cfg, chunk_q)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _serve_mla(p: Tree, x: torch.Tensor, positions: torch.Tensor, *,
               cfg: ArchConfig, rope_theta, cache: Dict[str, torch.Tensor],
               off: int, tp, chunk_q: int = 1024
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLA in the sharded serving body (as ``_serve_attention``): ``x``
    [B, S, D] this rank's rows, replicated over the model axis;
    ``cache`` its block [lo, hi) of the latent cache's length
    (``tp.kv_rows``), into which the rows' ``c_kv`` / ``k_rope`` are
    written in place (``_kv_put``).  The "lora" weights are whole, the
    rest the rank's heads.  A prefill (``off`` 0) runs the rank's heads
    over the sequence, query-chunked (``_mla_heads``); a one-token step
    takes the absorbed form against the block alone: every head's
    absorbed query (gathered over the heads' axis) scores the block's
    rows the token sees, each block gives its float32 latent context and
    log-sum-exp (``_mla_partial``: no visible row, weight 0), the blocks
    are merged (``tp.merge``), and the rank's heads take the merged
    context through ``wv_b``.  Split heads end in an all-reduce of
    ``wo``'s partial sums.  With the length in one block the step is
    ``mla_attention_absorbed``'s, op for op."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = mla_project(p, x, positions, cfg,
                                               rope_theta)
    length = cache["c_kv"].shape[1] * tp.kv_size
    if off + s > length:
        raise ValueError(f"cache write of {s} rows at {off} overruns "
                         f"{length} rows")
    lo, hi = tp.kv_rows(length)
    cache = _kv_put(cache, {"c_kv": c_kv, "k_rope": k_rope}, lo, off)
    hl = q_nope.shape[2]
    split = hl != cfg.n_heads
    if off == 0:
        out = _mla_heads(p, q_nope, q_rope, c_kv, k_rope, positions,
                         positions, cfg, chunk_q)
    elif s != 1:
        raise ValueError("the sharded serving body steps one token at a "
                         "time")
    elif tp.kv_size == 1:
        out = _mla_absorbed(p, q_nope, q_rope, cache, positions, off, cfg,
                            x.dtype)
    else:
        q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])  # absorbed
        r = q_c.shape[-1]
        q = torch.cat([q_c, q_rope], -1)
        if split:
            q = tp.concat(q, 2)
        ctx, lse = _mla_partial(q[..., :r].to(q_c.dtype),
                                q[..., r:].to(q_rope.dtype), cache,
                                min(hi, off + 1) - lo, cfg)
        ctx = tp.merge(ctx, lse).to(cache["c_kv"].dtype)
        if split:
            ctx = ctx.narrow(1, tp.index * hl, hl)
        out = _mla_values(p, ctx[:, None], x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return (tp.seq_scatter(y) if split else y), cache


def _mla_partial(q_c: torch.Tensor, q_rope: torch.Tensor,
                 block: Dict[str, torch.Tensor], n: int, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's absorbed attention over the first ``n`` rows of a
    latent cache block (the rows it sees): q_c [B,1,H,kvr] and q_rope
    [B,1,H,qr] of every head.  Returns the float32 latent context
    [B,H,kvr], normalised over those rows, and the log-sum-exp [B,H] of
    their scores; with no row to see, 0 and minus infinity, so that the
    merge weighs the block 0 (never a uniform average of rows past the
    write frontier)."""
    b, _, h, r = q_c.shape
    if n <= 0:
        return (q_c.new_zeros((b, h, r), dtype=torch.float32),
                q_c.new_full((b, h), -math.inf, dtype=torch.float32))
    c_kv, k_rope = block["c_kv"][:, :n], block["k_rope"][:, :n]
    scores = _mla_scores(q_c, q_rope, c_kv.to(q_c.dtype),
                         k_rope.to(q_rope.dtype), cfg)[:, :, 0]
    ctx = torch.einsum("bht,btr->bhr", torch.softmax(scores, -1),
                       c_kv.float())
    return ctx, torch.logsumexp(scores, -1)


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Tree:
    m = cfg.mla
    return {
        "c_kv": spec([batch, max_len, m.kv_lora_rank],
                     ["batch", "kv_len", "lora"], dtype, "zeros"),
        "k_rope": spec([batch, max_len, m.qk_rope_head_dim],
                       ["batch", "kv_len", "hdim"], dtype, "zeros"),
    }
