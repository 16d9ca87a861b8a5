"""gemma3-1b [dense]: 26L d_model=1152 4H (kv=1) head_dim=256 d_ff=6912
vocab=262144 -- 5:1 local(512-window):global layer pattern, local RoPE
theta 10k / global 1M, tied embeddings, 128k context
(hf:google/gemma-3-1b-pt; unverified).

The layer pattern is expressed structurally, as the reference config
has it: scan groups of (5 local + 1 global) x 4 + a 2-local tail = 26
layers, so each pattern position carries a static window and theta.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       ScanGroup)

_LOCAL_WINDOW = 512
_l = BlockSpec(Mixer.ATTN, FFN.DENSE, window=_LOCAL_WINDOW,
               rope_theta=10_000.0)
_g = BlockSpec(Mixer.ATTN, FFN.DENSE, window=None, rope_theta=1_000_000.0)

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab_size=262144, head_dim=256,
    groups=(ScanGroup("main", 4, (_l, _l, _l, _l, _l, _g)),
            ScanGroup("tail", 1, (_l, _l))),
    tie_embeddings=True,
    max_position=131_072,
    sub_quadratic=True,      # 22/26 layers local; 4 global layers have kv=1
    source="hf:google/gemma-3-1b-pt; unverified",
)


def reduced() -> ArchConfig:
    l = BlockSpec(Mixer.ATTN, FFN.DENSE, window=8, rope_theta=10_000.0)
    g = BlockSpec(Mixer.ATTN, FFN.DENSE, window=None, rope_theta=1_000_000.0)
    return dataclasses.replace(
        CONFIG, name="gemma3-reduced",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab_size=256, head_dim=32,
        groups=(ScanGroup("main", 1, (l, l, g)),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
