"""Model substrate of the port: configs, layers, GQA attention and
cross-attention, MLA, the RG-LRU and xLSTM recurrent blocks, the MoE FFN
and the composable stack (the training loss, prefill / decode, with a
VLM's prefix embeddings and an encoder-decoder's encoder tower)."""
from repro_torch.models.config import (ArchConfig, BlockSpec,
                                       EncoderConfig, FFN, Mixer,
                                       MLAConfig, MoEConfig,
                                       RecurrentConfig, ScanGroup, dense_lm)
from repro_torch.models.model import (RunFlags, build_cache_specs,
                                      build_param_specs, decode_step,
                                      prefill, train_loss)
from repro_torch.models.moe import (moe_dense, moe_ffn, moe_onehot,
                                    moe_specs, shared_expert)
from repro_torch.models.params import (ParamSpec, materialize, param_bytes,
                                       param_count, spec)

__all__ = [
    "ArchConfig", "BlockSpec", "EncoderConfig", "FFN", "Mixer", "MLAConfig",
    "MoEConfig", "RecurrentConfig", "ScanGroup", "dense_lm", "RunFlags",
    "build_cache_specs", "build_param_specs", "decode_step", "prefill",
    "train_loss",
    "moe_dense", "moe_ffn", "moe_onehot", "moe_specs", "shared_expert",
    "ParamSpec", "materialize", "param_bytes", "param_count", "spec",
]
