"""command-r-35b [dense]: 40L d_model=8192 64H (kv=8) d_ff=22528
vocab=256000 -- GQA, no-bias (hf:CohereForAI/c4ai-command-r-v01;
unverified)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer, \
    ScanGroup, dense_lm

CONFIG = dense_lm(
    "command-r-35b", n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    family="dense", source="hf:CohereForAI/c4ai-command-r-v01; unverified")


def reduced() -> ArchConfig:
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE)
    return dataclasses.replace(
        CONFIG, name="command-r-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (blk,)),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
