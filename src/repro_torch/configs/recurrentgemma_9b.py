"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1) d_ff=12288
vocab=256000 -- Griffin: RG-LRU recurrent blocks + local attention at a
2:1 recurrent:attention ratio, window 2048 (arXiv:2402.19427; unverified).

38 layers = 12 x (rglru, rglru, local-attn) superlayers + 2 trailing rglru
blocks (a separate scan group), as the reference config has them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       RecurrentConfig, ScanGroup)

_WINDOW = 2048
_r = BlockSpec(Mixer.RGLRU, FFN.DENSE)
_a = BlockSpec(Mixer.ATTN, FFN.DENSE, window=_WINDOW)

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256,
    groups=(ScanGroup("main", 12, (_r, _r, _a)),
            ScanGroup("tail", 1, (_r, _r))),
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4),
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2402.19427; unverified",
)


def reduced() -> ArchConfig:
    r = BlockSpec(Mixer.RGLRU, FFN.DENSE)
    a = BlockSpec(Mixer.ATTN, FFN.DENSE, window=8)
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-reduced",
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab_size=256, head_dim=32,
        groups=(ScanGroup("main", 1, (r, r, a)),
                ScanGroup("tail", 1, (r, r))),
        recurrent=RecurrentConfig(lru_width=64, conv_width=4),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
