"""Model configurations of the port (the dense and SSM families so far)."""
from .base import LayerPattern, ModelConfig, SSMConfig
from .registry import get_config, get_reduced_config

__all__ = ["ModelConfig", "LayerPattern", "SSMConfig", "get_config", "get_reduced_config"]
