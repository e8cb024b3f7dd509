"""Fused AMR attention: the hand-written CUDA kernels (``kernel``), their
plain versions (``ref``) and the op (``ops``: quantize -> kernel), reached
only as an op, as in the JAX package."""
from .ops import METHODS, fused_attention, fused_attention_reference

__all__ = ["METHODS", "fused_attention", "fused_attention_reference"]
