"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 -- alternating
mLSTM + sLSTM blocks, no separate FFN (projections live inside the blocks)
(arXiv:2405.04517; unverified)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                 ScanGroup)

_pattern = (BlockSpec(Mixer.MLSTM, FFN.NONE),
            BlockSpec(Mixer.SLSTM, FFN.NONE))

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    groups=(ScanGroup("main", 6, _pattern),),
    tie_embeddings=True,
    sub_quadratic=True,             # pure recurrent state, O(1) per token
    source="arXiv:2405.04517; unverified",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-reduced",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=256,
        groups=(ScanGroup("main", 2, _pattern),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
