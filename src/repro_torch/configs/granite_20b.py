"""granite-20b [dense]: 52L d_model=6144 48H (kv=1, MQA) d_ff=24576
vocab=49152 -- llama-style code model (arXiv:2405.04324; hf)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer, \
    ScanGroup, dense_lm

CONFIG = dense_lm(
    "granite-20b", n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    family="dense", source="arXiv:2405.04324; hf")


def reduced() -> ArchConfig:
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE)
    return dataclasses.replace(
        CONFIG, name="granite-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (blk,)),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
