"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
Enc-dec; the conv/mel frontend is a stub: the caller supplies
precomputed frame embeddings [B, 1500, 512] (``batch["source_embeds"]``)
(arXiv:2212.04356; unverified).

Adaptation notes (the reference's): the backbone uses this framework's
uniform RoPE+RMSNorm decoder blocks (original Whisper uses learned
absolute positions + LayerNorm); 6L = decoder depth, with a matching 6L
encoder tower per the whisper-base layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import (ArchConfig, BlockSpec,
                                       EncoderConfig, FFN, Mixer,
                                       ScanGroup)

_dec = BlockSpec(Mixer.ATTN, FFN.DENSE, cross_attention=True)

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865,
    groups=(ScanGroup("dec", 6, (_dec,)),),
    encoder=EncoderConfig(n_layers=6, source_len=1500,
                          frontend="audio_stub"),
    sub_quadratic=False,
    max_position=448 * 128,        # shapes drive the cache length
    source="arXiv:2212.04356; unverified",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-base-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256,
        groups=(ScanGroup("dec", 2, (_dec,)),),
        encoder=EncoderConfig(n_layers=2, source_len=8,
                              frontend="audio_stub"),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
