"""Model configurations of the port: the dense family (amr-paper-100m,
gemma-2b, gemma3-1b), the SSM family (mamba2-370m), the hybrid family
(zamba2-1.2b), the MoE family (dbrx-132b, moonshot-v1-16b-a3b), the audio
family (whisper-small) and the VLM family (internvl2-76b) so far;
``validate_config`` checks a config's cross-field invariants."""
from .base import LayerPattern, ModelConfig, MoEConfig, SSMConfig
from .registry import get_config, get_reduced_config
from .validation import validate_config

__all__ = ["ModelConfig", "LayerPattern", "MoEConfig", "SSMConfig", "get_config",
           "get_reduced_config", "validate_config"]
