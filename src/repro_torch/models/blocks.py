"""Single-layer block assembly: pre-norm mixer + pre-norm FFN residual.

One ``BlockSpec`` (config.py) describes a layer; ``block_param_specs``
builds its ParamSpec tree and ``apply_block`` runs it on a full sequence
without a cache (the training forward), on a full sequence that also
writes the cache at offset 0 (prefill), or on one token against the
cache (decode) -- the cache and its offset say which.

The port has the attention mixer (the Qwen2.5 / Llama block) and the
RG-LRU mixer (RecurrentGemma), each with the dense SwiGLU FFN or the
MoE FFN (``models/moe.py``: Mixtral).  Other mixers and FFNs raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec

Tree = Any

WINDOW_INF = 2 ** 30     # "no window": larger than any position

_LATER = {
    Mixer.MLA: "the MLA slice (DeepSeek-V2, MiniCPM3)",
    Mixer.MLSTM: "the xLSTM slice",
    Mixer.SLSTM: "the xLSTM slice",
    FFN.NONE: "the xLSTM slice",
}


def _supported(blk: BlockSpec) -> None:
    for part in (blk.mixer, blk.ffn):
        if part in _LATER:
            raise NotImplementedError(
                f"{part.value} blocks are not ported yet; they come with "
                f"{_LATER[part]}")
    if blk.cross_attention:
        raise NotImplementedError(
            "cross-attention is not ported yet; it comes with the "
            "encoder-decoder slice (whisper)")


def block_param_specs(cfg: ArchConfig, blk: BlockSpec) -> Tree:
    _supported(blk)
    d = cfg.d_model
    mixer = {"rglru": rec.rglru_specs(cfg)} if blk.mixer == Mixer.RGLRU \
        else {"attn": attn.gqa_specs(cfg)}
    ffn = moe_lib.moe_specs(cfg) if blk.ffn == FFN.MOE else mlp_spec(cfg)
    return {"norm_mixer": rmsnorm_spec(d), **mixer,
            "norm_ffn": rmsnorm_spec(d), "ffn": ffn}


def block_cache_specs(cfg: ArchConfig, blk: BlockSpec, batch: int,
                      max_len: int,
                      dtype: torch.dtype = torch.bfloat16) -> Tree:
    """Decode/prefill cache structure for one layer: the KV cache of an
    attention layer (in ``dtype``), the state of an RG-LRU layer."""
    _supported(blk)
    if blk.mixer == Mixer.RGLRU:
        return {"rglru": rec.rglru_state_spec(cfg, batch)}
    return {"attn": attn.gqa_cache_spec(cfg, batch, max_len, dtype)}


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
    causal: bool = True,
    moe_impl: Optional[str] = None,
    moe_group: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Returns (x, new_cache).  ``moe_impl`` / ``moe_group`` override the
    MoE config's dispatch and group size (``RunFlags``)."""
    _supported(blk)
    # without per-layer overrides the BlockSpec's window / theta hold
    if cfg.layer_windows is None and cfg.layer_thetas is None:
        window = blk.window
        theta = blk.rope_theta
    else:
        window = meta["window"]
        window = None if window >= WINDOW_INF else window
        theta = meta["theta"]

    h = rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    if blk.mixer == Mixer.RGLRU:
        y, nc = rec.rglru_block(p["rglru"], h, cfg=cfg,
                                state=cache["rglru"] if cache else None)
        new_cache = {"rglru": nc} if cache is not None else None
    else:
        y, nc = attn.gqa_attention(
            p["attn"], h, positions, cfg=cfg, window=window,
            rope_theta=theta, causal=causal,
            cache=cache["attn"] if cache else None,
            cache_offset=cache_offset)
        new_cache = {"attn": nc} if cache is not None else None
    x = x + y
    h = rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
    if blk.ffn == FFN.MOE:
        # the router's auxiliary loss is a training term: prefill and
        # decode drop it until the training slice adds ``train_loss``
        y, _ = moe_lib.moe_ffn(p["ffn"], h, cfg, impl=moe_impl,
                               group_size=moe_group)
    else:
        y = mlp(p["ffn"], h)
    return x + y, new_cache
