"""Model configurations of the port: the dense family (amr-paper-100m,
gemma-2b, gemma3-1b), the SSM family (mamba2-370m) and the hybrid family
(zamba2-1.2b) so far."""
from .base import LayerPattern, ModelConfig, SSMConfig
from .registry import get_config, get_reduced_config

__all__ = ["ModelConfig", "LayerPattern", "SSMConfig", "get_config", "get_reduced_config"]
