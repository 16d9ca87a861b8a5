"""internvl2-26b [vlm]: 48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.
InternLM2-20B language backbone; the InternViT vision tower is a stub:
the caller supplies precomputed patch embeddings [B, 256, 6144]
(``batch["prefix_embeds"]``), prepended to the token sequence
(arXiv:2404.16821; hf)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, BlockSpec, FFN, Mixer, \
    ScanGroup, dense_lm

CONFIG = dataclasses.replace(
    dense_lm(
        "internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab_size=92553, head_dim=128,
        family="vlm", source="arXiv:2404.16821; hf"),
    n_prefix_embeddings=256,
)


def reduced() -> ArchConfig:
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE)
    return dataclasses.replace(
        CONFIG, name="internvl2-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, n_prefix_embeddings=4,
        groups=(ScanGroup("main", 2, (blk,)),),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
