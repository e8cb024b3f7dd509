"""Model configurations of the port (the dense family so far)."""
from .base import LayerPattern, ModelConfig
from .registry import get_config, get_reduced_config

__all__ = ["ModelConfig", "LayerPattern", "get_config", "get_reduced_config"]
