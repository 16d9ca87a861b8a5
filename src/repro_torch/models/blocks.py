"""Single-layer block assembly: pre-norm mixer (+ pre-norm cross-
attention) + pre-norm FFN residual.

One ``BlockSpec`` (config.py) describes a layer; ``block_param_specs``
builds its ParamSpec tree and ``apply_block`` runs it on a full sequence
without a cache (the training forward, and the encoder tower), on a full
sequence that also writes the cache at offset 0 (prefill), or on a step
of one or more tokens against the cache at an offset above 0 (decode,
chunked prefill) -- the cache and its offset say which.

Every mixer of the reference is here: GQA attention (dense, windowed,
the encoder's bidirectional pass), MLA (naive in prefill, absorbed in
decode), the RG-LRU block, and xLSTM's mLSTM (parallel form in prefill,
its state folded by stepping; one step in decode) and sLSTM; the dense
SwiGLU FFN, the MoE FFN (``models/moe.py``) or none (xLSTM); and a
decoder block's cross-attention to the encoder output (its K/V
computed once at prefill, ``cross_kv``, and kept in the cache).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from repro_torch.models.params import spec

Tree = Any

WINDOW_INF = 2 ** 30     # "no window": larger than any position

_MIXER_SPECS = {
    Mixer.ATTN: ("attn", attn.gqa_specs),
    Mixer.MLA: ("attn", attn.mla_specs),
    Mixer.RGLRU: ("rglru", rec.rglru_specs),
    Mixer.MLSTM: ("mlstm", rec.mlstm_specs),
    Mixer.SLSTM: ("slstm", rec.slstm_specs),
}


def block_param_specs(cfg: ArchConfig, blk: BlockSpec) -> Tree:
    d = cfg.d_model
    key, specs = _MIXER_SPECS[blk.mixer]
    p: Dict[str, Tree] = {"norm_mixer": rmsnorm_spec(d), key: specs(cfg)}
    if blk.cross_attention:
        p["norm_cross"] = rmsnorm_spec(d)
        p["cross"] = attn.gqa_specs(cfg)
    if blk.ffn != FFN.NONE:
        p["norm_ffn"] = rmsnorm_spec(d)
        p["ffn"] = moe_lib.moe_specs(cfg) if blk.ffn == FFN.MOE \
            else mlp_spec(cfg)
    return p


def block_cache_specs(cfg: ArchConfig, blk: BlockSpec, batch: int,
                      max_len: int, *, source_len: int = 0,
                      dtype: torch.dtype = torch.bfloat16) -> Tree:
    """Decode/prefill cache structure for one layer: the KV cache of an
    attention layer and the latent cache of an MLA layer (in ``dtype``),
    the state of a recurrent layer, and a cross-attention block's encoder
    K/V of ``source_len`` rows (in ``dtype``)."""
    c: Dict[str, Tree] = {}
    if blk.mixer == Mixer.ATTN:
        c["attn"] = attn.gqa_cache_spec(cfg, batch, max_len, dtype)
    elif blk.mixer == Mixer.MLA:
        c["attn"] = attn.mla_cache_spec(cfg, batch, max_len, dtype)
    elif blk.mixer == Mixer.RGLRU:
        c["rglru"] = rec.rglru_state_spec(cfg, batch)
    elif blk.mixer == Mixer.MLSTM:
        c["mlstm"] = rec.mlstm_state_spec(cfg, batch)
    elif blk.mixer == Mixer.SLSTM:
        c["slstm"] = rec.slstm_state_spec(cfg, batch)
    if blk.cross_attention:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim_
        c["cross"] = {
            n: spec([batch, source_len, hkv, hd],
                    ["batch", "kv_len", "kv_heads", "hdim"], dtype, "zeros")
            for n in ("ek", "ev")}
    return c


def cross_kv(p: Tree, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-side K/V for cross attention (computed once at prefill)."""
    ek = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"])
    ev = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"])
    return ek, ev


def _mlstm_state_from_sequence(p: Tree, h: torch.Tensor, state0: Tree,
                               cfg: ArchConfig) -> Tree:
    """Fold a whole sequence into the mLSTM recurrent state (prefill),
    one ``mlstm_step`` a token from ``state0``."""
    st = state0
    for t in range(h.shape[1]):
        _, st = rec.mlstm_step(p, h[:, t:t + 1], st, cfg=cfg)
    return st


def apply_block(
    p: Tree,
    blk: BlockSpec,
    cfg: ArchConfig,
    x: torch.Tensor,                    # [B,S,D]
    positions: torch.Tensor,            # [B,S]
    meta: Dict[str, Any],               # this layer's window / theta
    *,
    cache: Optional[Tree] = None,
    cache_offset=None,
    enc_out: Optional[torch.Tensor] = None,   # encoder output (prefill)
    causal: bool = True,
    moe_impl: Optional[str] = None,
    moe_group: Optional[int] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (x, new_cache, aux): aux is the MoE router's auxiliary
    loss (a float32 scalar tensor; the float 0.0 for other FFNs, so a
    dense model's serving step launches nothing for it), which
    ``train_loss`` adds to the loss and prefill / decode ignore.  A
    decode step is a call with a cache at an offset above 0;
    ``enc_out`` feeds a cross-attention block's K/V in any other call.
    ``moe_impl`` / ``moe_group`` override the MoE config's dispatch and
    group size (``RunFlags``).  ``tp`` (a ``sharding.ModelShards``: a
    sharded step body, an attention + dense or MoE FFN block only):
    without a cache the train body, ``x`` this rank's block of rows and
    sequence; the norms run on it, the attention, a split dense FFN and
    the MoE FFN gather the sequence and scatter it back (Megatron
    sequence parallelism; the MoE routes whole dispatch groups), a dense
    FFN whose dim does not split runs on the block as it is.  With a
    cache the serving body (a ``sharding.ServeShards``): ``x`` is this
    rank's rows, replicated over the model axis; the attention writes
    the rank's block of the cache in place, and a split FFN's
    row-parallel ``wo`` (the MoE's partial sums) ends in an
    all-reduce."""
    if tp is not None and (blk.mixer != Mixer.ATTN or blk.ffn == FFN.NONE
                           or blk.cross_attention):
        raise ValueError("the sharded bodies run attention + dense or MoE "
                         "FFN blocks only")
    # without per-layer overrides the BlockSpec's window / theta hold
    if cfg.layer_windows is None and cfg.layer_thetas is None:
        window = blk.window
        theta = blk.rope_theta
    else:
        window = meta["window"]
        window = None if window >= WINDOW_INF else window
        theta = meta["theta"]
    decode = cache is not None and int(cache_offset or 0) > 0
    aux = 0.0
    new_cache: Optional[Dict[str, Tree]] = {} if cache is not None else None

    h = rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    if blk.mixer == Mixer.ATTN:
        y, nc = attn.gqa_attention(
            p["attn"], h, positions, cfg=cfg, window=window,
            rope_theta=theta, causal=causal,
            cache=cache["attn"] if cache else None,
            cache_offset=cache_offset, tp=tp)
    elif blk.mixer == Mixer.MLA:
        if decode:
            y, nc = attn.mla_attention_absorbed(
                p["attn"], h, positions, cfg=cfg, cache=cache["attn"],
                cache_offset=cache_offset, rope_theta=theta)
        else:
            y, nc = attn.mla_attention_naive(
                p["attn"], h, positions, cfg=cfg, rope_theta=theta,
                cache=cache["attn"] if cache else None)
    elif blk.mixer == Mixer.RGLRU:
        y, nc = rec.rglru_block(p["rglru"], h, cfg=cfg,
                                state=cache["rglru"] if cache else None)
    elif blk.mixer == Mixer.MLSTM:
        if decode:
            y, nc = rec.mlstm_step(p["mlstm"], h, cache["mlstm"], cfg=cfg)
        else:
            y = rec.mlstm_parallel(p["mlstm"], h, cfg=cfg)
            nc = None if cache is None else _mlstm_state_from_sequence(
                p["mlstm"], h, cache["mlstm"], cfg)
    else:
        y, nc = rec.slstm_sequence(p["slstm"], h, cfg=cfg,
                                   state=cache["slstm"] if cache else None)
    if new_cache is not None:
        new_cache[_MIXER_SPECS[blk.mixer][0]] = nc
    x = x + y

    if blk.cross_attention:
        h = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        if decode:
            ek, ev = cache["cross"]["ek"], cache["cross"]["ev"]
        else:
            if enc_out is None:
                raise ValueError("cross-attention needs the encoder output")
            ek, ev = cross_kv(p, enc_out)
        y, _ = attn.gqa_attention(
            p["cross"], h, positions, cfg=cfg, causal=False,
            cache_offset=cache_offset,
            kv_override=(ek.to(h.dtype), ev.to(h.dtype)))
        if new_cache is not None:
            new_cache["cross"] = {"ek": ek.to(cache["cross"]["ek"].dtype),
                                  "ev": ev.to(cache["cross"]["ev"].dtype)}
        x = x + y

    if blk.ffn != FFN.NONE:
        h = rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        if blk.ffn == FFN.MOE:
            y, aux = moe_lib.moe_ffn(p["ffn"], h, cfg, impl=moe_impl,
                                     group_size=moe_group, tp=tp)
        else:
            split = tp is not None and \
                p["ffn"]["wi_gate"].shape[-1] != cfg.d_ff
            y = mlp(p["ffn"], h, tp if split else None)
        x = x + y
    return x, new_cache, aux
