"""Arch registry: ``--arch <id>`` resolution for the port's launchers, and
the families the conformance matrix sweeps."""
from __future__ import annotations

import importlib

from .base import ModelConfig

# the JAX package's registry order (``families()`` and the matrix follow it)
_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-370m": "mamba2_370m",
    "qwen3-32b": "qwen3_32b",
    "gemma3-1b": "gemma3_1b",
    "minitron-8b": "minitron_8b",
    "gemma-2b": "gemma_2b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_16b_a3b",
    "whisper-small": "whisper_small",
    "internvl2-76b": "internvl2_76b",
    "amr-paper-100m": "amr_paper",
}

ALL_NAMES = list(_MODULES)
ARCH_NAMES = ALL_NAMES  # the launchers' --arch choices: every arch, amr-paper-100m too


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()


def family_of(name: str) -> str:
    """The family ('dense'/'ssm'/'hybrid'/'moe'/'audio'/'vlm') of a
    registered arch, read from its config."""
    return get_config(name).family


def families() -> dict[str, list[str]]:
    """Every registered family -> its arch names, in registry order (the
    conformance matrix's sweep axes derive from this)."""
    out: dict[str, list[str]] = {}
    for n in ALL_NAMES:
        out.setdefault(family_of(n), []).append(n)
    return out
