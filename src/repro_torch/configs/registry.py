"""Arch registry: ``--arch <id>`` resolution for the port's launcher."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "amr-paper-100m": "amr_paper",
    "gemma-2b": "gemma_2b",
    "gemma3-1b": "gemma3_1b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-1.2b": "zamba2_1p2b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_16b_a3b",
    "whisper-small": "whisper_small",
    "internvl2-76b": "internvl2_76b",
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()
