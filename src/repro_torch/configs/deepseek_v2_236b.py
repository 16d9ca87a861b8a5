"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6
(arXiv:2405.04434; hf)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec, FFN,
                                       MLAConfig, Mixer, MoEConfig,
                                       ScanGroup)

_blk = BlockSpec(Mixer.MLA, FFN.MOE)

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab_size=102400, head_dim=128,
    groups=(ScanGroup("main", 60, (_blk,)),),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared_experts=2, d_ff_shared=3072,
                  capacity_factor=1.25),
    sub_quadratic=False,            # MLA compresses KV but attn is global
    source="arXiv:2405.04434; hf",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256, head_dim=16,
        groups=(ScanGroup("main", 2, (_blk,)),),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, d_ff_shared=32,
                      capacity_factor=2.0),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
