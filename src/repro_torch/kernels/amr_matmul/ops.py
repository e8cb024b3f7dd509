"""Public AMR-matmul op: float matmul under AMR-MUL numerics.

The port of the JAX package's ``kernels/amr_matmul/ops.py``: quantize
(per row of A, per column of B), run a kernel variant, then rescale in the
reference's order, ``acc.float() * sa * sb``.

* ``method="lut"``     — full 256x256 table gather, bit-exact AMR products
  with int32 accumulation;
* ``method="lowrank"`` — rank-r SVD factors of the error table; per product
  the error against the full table is at most sigma_{r+1} (core/lut.py).

The table a kernel gathers from is the narrowest exact one: int16 when
every product of the border fits it (128 KB, which the gather kernels
stage into each SM's shared memory on large calls and read through L1 on
small ones), int32 otherwise (256 KB, more than a block's shared memory:
read through L1).  The kernels take contiguous operands, so the quantized
operands are made contiguous here (a no-op for the dense sites).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.numerics.quant import quantize_int8

from .kernel import amr_matmul_int8, amr_matmul_int8_lut, amr_matmul_int8_lut_grouped

METHODS = ("lowrank", "lut")
_INT16_MAX = 32767


@lru_cache(maxsize=64)
def kernel_table(border: int | None, device: torch.device) -> torch.Tensor:
    """The product table in the narrowest dtype that holds it exactly."""
    table = lut_lib.table_tensor(border, device)
    return table.to(torch.int16) if lut_lib.table_max_abs(border) <= _INT16_MAX else table


def check_accumulation(k: int, border: int | None, what: str) -> None:
    """Raise when K * max|product| could saturate the int32 accumulator."""
    check_max_abs(k, lut_lib.table_max_abs(border), what)


def check_max_abs(k: int, max_abs: int, what: str) -> None:
    """Raise when K products of at most ``max_abs`` could saturate int32."""
    if k * max_abs >= 2**31:
        raise ValueError(
            f"{what} int32 accumulator can saturate: K={k} with "
            f"max|product|={max_abs} gives K*max|product| = {k * max_abs} "
            f">= 2**31 = {2**31}; keep K <= {(2**31 - 1) // max_abs} "
            f"(or split the contraction before the matmul)")


def amr_matmul(a: torch.Tensor, b: torch.Tensor, *, border: int | None = 8,
               rank: int = 8, method: str = "lowrank") -> torch.Tensor:
    """Float (M, K) @ (K, N) with AMR-MUL product semantics -> float32."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    qa, sa = quantize_int8(a, axis=-1)
    qb, sb = quantize_int8(b, axis=0)
    qa, qb = qa.contiguous(), qb.contiguous()
    if method == "lut":
        check_accumulation(a.shape[-1], border, f"amr_matmul(lut, border={border})")
        out = amr_matmul_int8_lut(qa, qb, kernel_table(border, a.device)).float()
    else:
        u, v = lut_lib.factor_tensors(border, rank, a.device)
        out = amr_matmul_int8(qa, qb, u, v)
    return out * sa * sb


def amr_matmul_grouped(a: torch.Tensor, b: torch.Tensor, *,
                       border: int | None = 8) -> torch.Tensor:
    """Grouped float (G, M, K) @ (G, K, N) under bit-exact full-LUT numerics.

    Quantization is per row of A and per column of B within each group, so
    the result is bit-identical to stacking per-group ``method="lut"``
    calls.
    """
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"amr_matmul_grouped takes (G, M, K) @ (G, K, N) with matching "
            f"group counts, got {tuple(a.shape)} @ {tuple(b.shape)}")
    check_accumulation(a.shape[-1], border, f"amr_matmul_grouped(border={border})")
    qa, sa = quantize_int8(a, axis=-1)
    qb, sb = quantize_int8(b, axis=-2)
    out = amr_matmul_int8_lut_grouped(qa.contiguous(), qb.contiguous(),
                                      kernel_table(border, a.device))
    return out.float() * sa * sb
