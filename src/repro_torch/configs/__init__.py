"""Architecture configs the port can build: all eleven of the reference's.

Each module exports CONFIG (the full-scale config) and ``reduced()`` (a
structurally identical small config for CPU tests).  ``get_config`` /
``ARCHS`` are the registry the launcher consumes (``--arch <id>``).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ArchConfig

_MODULES = [
    "qwen2_5_7b",          # the paper's section 4.3 validation model
    "recurrentgemma_9b",   # hybrid: RG-LRU + local attention
    "gemma3_1b",           # dense: 5:1 local:global windows and thetas
    "granite_20b",         # dense: MQA (48 query heads over 1 kv head)
    "command_r_35b",       # dense: GQA, the largest dense checkpoint
    "internvl2_26b",       # vlm: 256 prefix embeddings before the tokens
    "mixtral_8x22b",       # moe: 8 experts top-2, sliding window
    "minicpm3_4b",         # dense: MLA attention
    "deepseek_v2_236b",    # moe: MLA + 160 routed / 2 shared experts
    "whisper_base",        # audio: encoder tower + cross-attention
    "xlstm_125m",          # ssm: mLSTM + sLSTM, no FFN
]

ARCHS: List[str] = [m.replace("_", "-") for m in _MODULES]


def _module(name: str):
    key = name.replace("-", "_").replace(".", "_")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
