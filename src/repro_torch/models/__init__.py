"""Model substrate of the port: configs, layers, GQA attention, the
RG-LRU recurrent block and the composable stack (prefill / decode).
MoE, MLA, the xLSTM blocks and the training loss come with later
slices."""
from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       MLAConfig, MoEConfig,
                                       RecurrentConfig, ScanGroup, dense_lm)
from repro_torch.models.model import (RunFlags, build_cache_specs,
                                      build_param_specs, decode_step,
                                      prefill)
from repro_torch.models.params import (ParamSpec, materialize, param_bytes,
                                       param_count, spec)

__all__ = [
    "ArchConfig", "BlockSpec", "FFN", "Mixer", "MLAConfig", "MoEConfig",
    "RecurrentConfig", "ScanGroup", "dense_lm", "RunFlags",
    "build_cache_specs", "build_param_specs", "decode_step", "prefill",
    "ParamSpec", "materialize", "param_bytes", "param_count", "spec",
]
