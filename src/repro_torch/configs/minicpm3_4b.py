"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 -- MLA
attention with dense FFN (hf:openbmb/MiniCPM3-4B; hf)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN,
                                       MLAConfig, Mixer, ScanGroup)

_blk = BlockSpec(Mixer.MLA, FFN.DENSE)

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73448, head_dim=64,
    groups=(ScanGroup("main", 62, (_blk,)),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64),
    sub_quadratic=False,
    source="hf:openbmb/MiniCPM3-4B; hf",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (_blk,)),),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
