"""Numerics policy: how the paper's approximate multiplier enters the
model's matmuls (``AMRNumerics`` + ``approx_matmul``), and the int8
quantizer it rests on."""
from .approx_matmul import AMRNumerics, approx_matmul, mode_names
from .quant import dequantize, quantize_int8

__all__ = ["AMRNumerics", "approx_matmul", "mode_names", "quantize_int8", "dequantize"]
