"""Architecture configs the port can build.

Each module exports CONFIG (the full-scale config) and ``reduced()`` (a
structurally identical small config for CPU tests).  ``get_config`` /
``ARCHS`` are the registry the launcher consumes (``--arch <id>``).
The reference's other nine configs join as the blocks they need are
ported (ROADMAP.md).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ArchConfig

_MODULES = [
    "qwen2_5_7b",          # the paper's section 4.3 validation model
    "recurrentgemma_9b",   # hybrid: RG-LRU + local attention
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
