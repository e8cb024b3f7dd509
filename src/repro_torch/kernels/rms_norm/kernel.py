"""Wrapper of the hand-written row mean-square kernel
(``csrc/row_mean_square.cu``), the reduction of every RMSNorm of the port.

``mean_square(x)`` is the mean of x * x over the last dim, kept as a dim of
1, in float32.  The kernel adds each row's squares in float64 in an order
that its length alone fixes, so a served request's norm has the same bits
in a batch as alone, with one launch a norm whatever the batch, and the
card's norms are the CPU's (``ref.mean_square_ref``) but where a float64
sum sits at a float32 rounding boundary.  The JAX package has no Pallas
kernel for it (XLA fuses its ``jnp.mean``).

A tensor's device decides the route: CPU tensors go to the plain version
(``ref.mean_square_ref``); CUDA tensors go to the kernel, which raises on
what it does not take.  Where autograd records, the CUDA call runs inside
``_MeanSquare``, whose backward gives the bits autograd gives the plain
version.  The wrapper makes x contiguous and 16-byte aligned (copying a
view that is not), launches on PyTorch's current stream and counts the
launch on ``ROW_MS``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaKernel, CudaLibrary
from .ref import mean_square_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "row_mean_square.cu")
LIBRARIES = (LIBRARY,)

_P = ctypes.c_void_p
ROW_MS = CudaKernel("row_mean_square", LIBRARY, "row_mean_square",
                    [_P, _P, ctypes.c_longlong, ctypes.c_int, _P])
KERNELS = (ROW_MS,)

ROWS_PER_BLOCK = 8  # kWarps in row_mean_square.cu: one warp a row


def mean_square(x: torch.Tensor) -> torch.Tensor:
    """x (..., d) float32 -> (..., 1) float32, the mean of x * x over d."""
    if x.device.type == "cpu":
        return mean_square_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"mean_square takes CPU or CUDA tensors, got {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _MeanSquare.apply(x)
    return _mean_square_cuda(x)


def _mean_square_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"the row mean-square kernel takes float32, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"mean_square takes (..., d) with d >= 1, got {tuple(x.shape)}")
    d = x.shape[-1]
    out = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rows = out.numel()
    if rows == 0:
        return out
    x = x.contiguous()
    if d % 4 == 0 and x.data_ptr() % 16:  # the kernel reads float4s
        x = x.clone()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ROW_MS(x.data_ptr(), out.data_ptr(), rows, d, stream)
    return out


class _MeanSquare(torch.autograd.Function):
    """The kernel under autograd; the backward is elementwise."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _mean_square_cuda(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # autograd of the plain version: g / d broadcast in float64, then
        # g x + g x, rounded to x's dtype
        return ((g.double() / x.shape[-1]) * x.double() * 2).to(x.dtype)
