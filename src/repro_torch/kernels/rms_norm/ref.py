"""Plain PyTorch version of the row mean-square kernel: the JAX package's
``jnp.mean(x * x, axis=-1, keepdims=True)`` (``models/layers.py::rms_norm``),
summed in float64 and rounded once to float32."""
from __future__ import annotations

import torch


def mean_square_ref(x: torch.Tensor) -> torch.Tensor:
    """The mean of x * x over the last dim, kept as a dim of 1, in float32.

    The squares of float32 values are exact in float64 and their float64
    sum is within d 2^-53 of the exact sum whatever the order, so this
    and the kernel round to the same float32 but where the two sums
    straddle a rounding boundary (then one ulp apart): a one-ulp gap in a
    norm can move an int8 index that sits at a rounding tie, which the
    card and the CPU then no longer share.
    """
    xd = x.double()
    return (xd * xd).mean(dim=-1, keepdim=True).to(x.dtype)
