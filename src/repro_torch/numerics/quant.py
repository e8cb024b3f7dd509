"""Symmetric int8 quantization for approximate-multiplier matmuls.

The same arithmetic as the JAX package's ``numerics/quant.py``, so the
int8 indices and scales agree bit for bit:

* the absmax scale is computed in the input dtype (``max(amax, eps) /
  127``) and cast to float32 only after the division by it;
* ``torch.round`` rounds half to even, as ``jnp.round`` does.

``quantize_int8_ste`` is the straight-through form, as in the JAX
package: float values on the int8 grid, ``xs + (q - xs).detach()`` with
``xs = x.float() / scale``, so the gradient is that of ``xs`` (through the
scale too).  ``q - xs`` is exact in float32, so the forward bits are those
of ``q``.
"""
from __future__ import annotations

import contextlib

import torch

INT8_MAX = 127.0
_recorded: list | None = None  # a list while ``record_quantizations`` is open


@contextlib.contextmanager
def record_quantizations():
    """Record every quantization made inside the block, in call order, into
    the list it yields: (the float32 values that were rounded, ``x /
    scale``; their int8 grid values as float32), both detached.  Two runs
    of one forward on two devices then compare index by index.  One
    recorder per process: the block is not thread-safe."""
    global _recorded
    outer, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = outer


def _record(xs: torch.Tensor, q: torch.Tensor) -> None:
    if _recorded is not None:
        _recorded.append((xs.detach().float(), q.detach().float()))


def _absmax_scale(x: torch.Tensor, axis: int | None, eps: float) -> torch.Tensor:
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=eps) / INT8_MAX


def quantize_int8(x: torch.Tensor, axis: int | None = None,
                  eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization -> (q int8, scale float32), x ~= q * scale.

    axis=None -> per-tensor scale; axis=k -> scale reduced over axis k.
    """
    scale = _absmax_scale(x, axis, eps)
    xs = x / scale
    q = torch.clamp(torch.round(xs), -INT8_MAX - 1, INT8_MAX)
    _record(xs, q)
    return q.to(torch.int8), scale.float()


def quantize_int8_ste(x: torch.Tensor, axis: int | None = None,
                      eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Straight-through quantization: (q float32 on the int8 grid, scale),
    d(q)/dx that of ``x.float() / scale`` (identity through round and clip)."""
    scale = _absmax_scale(x, axis, eps)
    xs = x.float() / scale.float()
    q = torch.clamp(torch.round(xs), -INT8_MAX - 1, INT8_MAX)
    _record(xs, q)
    if xs.requires_grad:
        q = xs + (q - xs).detach()
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
