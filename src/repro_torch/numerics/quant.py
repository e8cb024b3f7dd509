"""Symmetric int8 quantization for approximate-multiplier matmuls.

The same arithmetic as the JAX package's ``numerics/quant.py``, so the
int8 indices and scales agree bit for bit:

* the absmax scale is computed in the input dtype (``max(amax, eps) /
  127``) and cast to float32 only after the division by it;
* ``torch.round`` rounds half to even, as ``jnp.round`` does.

``quantize_int8_ste`` is forward-only in this port (no autograd.Function
yet): it returns the float-on-the-int8-grid values the straight-through
form feeds forward, dividing in float32 by the input-dtype scale.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def _absmax_scale(x: torch.Tensor, axis: int | None, eps: float) -> torch.Tensor:
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=eps) / INT8_MAX


def quantize_int8(x: torch.Tensor, axis: int | None = None,
                  eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization -> (q int8, scale float32), x ~= q * scale.

    axis=None -> per-tensor scale; axis=k -> scale reduced over axis k.
    """
    scale = _absmax_scale(x, axis, eps)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX).to(torch.int8)
    return q, scale.float()


def quantize_int8_ste(x: torch.Tensor, axis: int | None = None,
                      eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward of the straight-through form: (q float32 on the int8 grid, scale)."""
    scale = _absmax_scale(x, axis, eps)
    q = torch.clamp(torch.round(x.float() / scale.float()), -INT8_MAX - 1, INT8_MAX)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
