"""qwen2.5-7b: the paper's section 4.3 real-model validation subject
(Qwen2.5-7B fp16, ~14.9 GB).  28L d_model=3584 28H (kv=4) d_ff=18944
vocab=152064 (arXiv:2412.15115).  The block follows the repository's
architecture (no QKV bias), as the reference config does."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer, \
    ScanGroup, dense_lm

CONFIG = dense_lm(
    "qwen2-5-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, rope_theta=1_000_000.0,
    family="dense", source="arXiv:2412.15115; hf")


def reduced() -> ArchConfig:
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE)
    return dataclasses.replace(
        CONFIG, name="qwen2-5-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (blk,)),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
