"""GQA/MQA/MHA attention mixer with its KV cache (full and sliding-window
attention, in prefill and in decode).

The attention itself goes through the port's kernels (``kernels/ops``):
``flash_attention`` for a prefill at cache offset 0 (with or without a
cache), ``decode_attention`` for a one-token step against the cache.
On the card they are the hand-written CUDA kernels; on the CPU their
plain PyTorch versions.  This is the reference's function
(``repro/models/attention.py`` ``gqa_attention``, which computes it with
jnp) within the kernels' tolerances: the kernels keep the softmax
weights in float32 where the reference rounds them to the value dtype.

A decode step hands ``decode_attention`` a view of the cache rows it
may see: rows [off + 1 - window, off] with a window, [0, off] without.
Cases the kernels cannot express raise ``NotImplementedError`` instead
of being computed another way: a logit softcap and a multi-token step at
a nonzero offset.  MLA and cross-attention come with later slices.

The KV cache is ``[B, T, Hkv, D]`` per layer (float32, bfloat16 or int8
with per-(token, head) scales).  Writes are out of place
(``torch.slice_scatter``), as the reference's ``dynamic_update_slice``:
the serving engine merges only the rows it stepped.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import spec

Tree = Any


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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full/windowed GQA.  With a cache: writes K/V at ``cache_offset``
    and attends over the cache up to the write frontier."""
    b, s, _ = x.shape
    off = 0 if cache_offset is None else int(cache_offset)
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            "attention logit softcap: the attention kernels have no "
            "softcap; it comes with the gemma-family slice")
    if off > 0 and s > 1:
        raise NotImplementedError(
            f"a {s}-token step at cache offset {off} (chunked prefill) has "
            f"no kernel; it comes with a later serving slice")
    if off > 0 and cache is None:
        raise ValueError("a decode step at a nonzero offset needs a cache")

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    new_cache = None
    lo = 0
    if cache is not None:
        t = cache["k"].shape[1]
        new_cache = dict(cache)
        new_cache.update(_kv_write(cache, "k", k, off))
        new_cache.update(_kv_write(cache, "v", v, off))
        if off > 0:
            # decode: only the rows the query may see, [lo, off] (the
            # window is exact here: every row of the call is at ``off``)
            lo = 0 if window is None else max(0, off + 1 - window)
            rows = {n: c[:, lo:off + 1] for n, c in new_cache.items()}
            k = _kv_read(rows, "k", q.dtype)
            v = _kv_read(rows, "v", q.dtype)
        elif s != t:
            # prefill into a longer cache: read it back; rows past the
            # frontier are masked by causality
            k = _kv_read(new_cache, "k", q.dtype)
            v = _kv_read(new_cache, "v", q.dtype)
    k, v = k.to(q.dtype), v.to(q.dtype)

    # the kernels take [B, heads, seq, D] views of the [B, seq, heads, D]
    # activations and cache, by strides, with no copy
    if off == 0:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    else:
        length = torch.full((b,), off + 1 - lo, dtype=torch.int32,
                            device=x.device)
        out = ops.decode_attention(q[:, 0], k.transpose(1, 2),
                                   v.transpose(1, 2), length)[:, None]
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


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
