"""Model configurations of the port, every arch of the JAX package's
registry: the dense family (qwen3-32b, gemma3-1b, minitron-8b, gemma-2b,
amr-paper-100m), the SSM family (mamba2-370m), the hybrid family
(zamba2-1.2b), the MoE family (dbrx-132b, moonshot-v1-16b-a3b), the audio
family (whisper-small) and the VLM family (internvl2-76b);
``validate_config`` checks a config's cross-field invariants."""
from .base import LayerPattern, ModelConfig, MoEConfig, SSMConfig
from .registry import (ALL_NAMES, ARCH_NAMES, families, family_of, get_config,
                       get_reduced_config)
from .validation import validate_config

__all__ = ["ModelConfig", "LayerPattern", "MoEConfig", "SSMConfig", "ARCH_NAMES", "ALL_NAMES",
           "get_config", "get_reduced_config", "family_of", "families", "validate_config"]
