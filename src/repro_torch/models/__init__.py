"""Model substrate of the port: configs, layers, GQA attention, the
RG-LRU recurrent block, the MoE FFN and the composable stack (prefill /
decode, with a VLM's prefix embeddings).  MLA, the encoder tower, the
xLSTM blocks and the training loss come with later slices."""
from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       MLAConfig, MoEConfig,
                                       RecurrentConfig, ScanGroup, dense_lm)
from repro_torch.models.model import (RunFlags, build_cache_specs,
                                      build_param_specs, decode_step,
                                      prefill)
from repro_torch.models.moe import (moe_dense, moe_ffn, moe_onehot,
                                    moe_specs, shared_expert)
from repro_torch.models.params import (ParamSpec, materialize, param_bytes,
                                       param_count, spec)

__all__ = [
    "ArchConfig", "BlockSpec", "FFN", "Mixer", "MLAConfig", "MoEConfig",
    "RecurrentConfig", "ScanGroup", "dense_lm", "RunFlags",
    "build_cache_specs", "build_param_specs", "decode_step", "prefill",
    "moe_dense", "moe_ffn", "moe_onehot", "moe_specs", "shared_expert",
    "ParamSpec", "materialize", "param_bytes", "param_count", "spec",
]
