"""mixtral-8x22b [moe]: 56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention (arXiv:2401.04088; hf)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       MoEConfig, ScanGroup)

_WINDOW = 4096
_blk = BlockSpec(Mixer.ATTN, FFN.MOE, window=_WINDOW)

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, head_dim=128,
    groups=(ScanGroup("main", 56, (_blk,)),),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25, group_size=2048),
    sub_quadratic=True,             # SWA bounds the attention span
    source="arXiv:2401.04088; hf",
)


def reduced() -> ArchConfig:
    blk = BlockSpec(Mixer.ATTN, FFN.MOE, window=8)
    return dataclasses.replace(
        CONFIG, name="mixtral-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (blk,)),),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
