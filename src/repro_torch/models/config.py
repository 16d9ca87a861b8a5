"""Architecture configuration: one dataclass drives model build, cache
layout and the analytic parameter / FLOP model.

A model is an embedding + a sequence of *scan groups*.  Each group is
(repeats x pattern) where the pattern is a short list of blocks; the
port runs the repeats as a Python loop over layers whose parameters are
stacked along a leading "layers" axis (the reference's ``lax.scan``
layout, so weights carry across as plain copies).  Per-layer *metadata*
(attention window, rope theta) rides along per layer.

The data classes are the reference's; dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class Mixer(str, enum.Enum):
    ATTN = "attn"            # GQA/MQA/MHA full or sliding-window attention
    MLA = "mla"              # multi-head latent attention (DeepSeek/MiniCPM)
    RGLRU = "rglru"          # RecurrentGemma RG-LRU block (conv1d + LRU)
    MLSTM = "mlstm"          # xLSTM matrix-memory block
    SLSTM = "slstm"          # xLSTM scalar-memory block


class FFN(str, enum.Enum):
    DENSE = "dense"          # SwiGLU MLP
    MOE = "moe"              # routed experts (+ optional shared experts)
    NONE = "none"            # block has no separate FFN (xLSTM)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: Mixer
    ffn: FFN = FFN.DENSE
    # attention metadata (None window = full/global attention)
    window: Optional[int] = None
    rope_theta: float = 10_000.0
    cross_attention: bool = False    # decoder block attending to encoder


@dataclasses.dataclass(frozen=True)
class ScanGroup:
    name: str
    repeats: int
    pattern: Tuple[BlockSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.repeats * len(self.pattern)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0                 # total shared width (0 = none)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    impl: str = "onehot"                 # onehot | dense
    group_size: int = 0                  # 0 = one group


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 0                   # defaults to d_model when 0
    conv_width: int = 4
    expand: float = 1.0                  # rglru input expansion


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """For enc-dec archs (whisper): a separate bidirectional encoder."""
    n_layers: int
    source_len: int                      # e.g. 1500 audio frames
    frontend: str = "audio_stub"         # precomputed embeddings (stub)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # defaults to d_model // n_heads
    groups: Tuple[ScanGroup, ...] = ()
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_prefix_embeddings: int = 0         # VLM stub: image tokens prepended
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_logit_softcap: Optional[float] = None
    sub_quadratic: bool = False          # eligible for long_500k shape
    # optional flat per-layer overrides (length n_layers, group-major order)
    # for heterogeneous-in-metadata stacks (gemma3's 5:1 local:global)
    layer_windows: Optional[Tuple[Optional[int], ...]] = None
    layer_thetas: Optional[Tuple[float, ...]] = None
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    max_position: int = 131_072
    source: str = ""                     # provenance tag

    # ---------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def total_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    def validate(self) -> None:
        if self.total_layers != self.n_layers:
            raise ValueError(
                f"{self.name}: groups define {self.total_layers} layers, "
                f"config says {self.n_layers}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")
        for g in self.groups:
            for b in g.pattern:
                if b.mixer == Mixer.MLA and self.mla is None:
                    raise ValueError(f"{self.name}: MLA block without mla cfg")
                if b.ffn == FFN.MOE and self.moe is None:
                    raise ValueError(f"{self.name}: MoE block without moe cfg")
                if b.mixer == Mixer.RGLRU and self.recurrent is None:
                    raise ValueError(f"{self.name}: RGLRU without recurrent")

    # -- analytic parameter / FLOP model ------------------------------
    def param_count(self) -> int:
        from repro_torch.models.model import build_param_specs  # no cycle
        from repro_torch.models.params import param_count
        return param_count(build_param_specs(self))

    def active_param_count(self) -> int:
        """Activated params per token (= dense count for non-MoE)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m, d = self.moe, self.d_model
        per_expert = 3 * d * m.d_ff_expert
        moe_layers = sum(
            g.repeats * sum(1 for b in g.pattern if b.ffn == FFN.MOE)
            for g in self.groups)
        inactive = per_expert * (m.n_experts - m.top_k) * moe_layers
        return total - inactive

    def model_flops_per_token(self, train: bool = True) -> float:
        """MODEL_FLOPS = 6 N_active per token (3 fwd+bwd passes x 2 MAC),
        or 2 N_active for inference forward-only."""
        mult = 6.0 if train else 2.0
        return mult * self.active_param_count()


def dense_lm(name: str, *, n_layers: int, d_model: int, n_heads: int,
             n_kv_heads: int, d_ff: int, vocab_size: int,
             head_dim: Optional[int] = None, window: Optional[int] = None,
             rope_theta: float = 10_000.0, family: str = "dense",
             source: str = "", **kw) -> ArchConfig:
    """Helper for the common single-scan-group decoder-only LM."""
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE, window=window,
                    rope_theta=rope_theta)
    return ArchConfig(
        name=name, family=family, n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
        vocab_size=vocab_size, head_dim=head_dim, rope_theta=rope_theta,
        groups=(ScanGroup("main", n_layers, (blk,)),), source=source, **kw)
