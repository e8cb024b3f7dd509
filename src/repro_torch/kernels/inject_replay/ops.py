"""Public circuit-replay ops: exact integer AMR matmuls for any schedule.

The port of the JAX package's ``kernels/inject_replay/ops.py``, with the
same contract: int32 operand indices (value + 128) in, int32 sums out,
bit-identical to the schedule's 256x256 table.  They also stand for the JAX
package's ``injection.injected_matmul_int`` / ``injected_matmul_grouped``.
CUDA tensors run the hand kernel, CPU tensors its plain version.  Both raise before running when K * max|product| could
saturate the int32 accumulator.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.engine import CompiledInjector
from repro_torch.numerics.injection import check_accumulation_bound

from .kernel import inject_replay_int32


def inject_replay_matmul(inj: CompiledInjector, ia: torch.Tensor, ib: torch.Tensor, *,
                         schedule: str | None = None) -> torch.Tensor:
    """ia (..., M, K), ib (K, N) int32 operand indices -> (..., M, N) int32."""
    *lead, m, k = ia.shape
    if ib.dim() != 2:
        raise ValueError(f"ib must be (K, N), got shape {tuple(ib.shape)}")
    check_accumulation_bound(inj, k, schedule=schedule)
    rows = math.prod(lead) * m
    out = inject_replay_int32(inj, ia.reshape(1, rows, k).contiguous(), ib.contiguous())
    return out.reshape(*lead, m, ib.shape[1])


def inject_replay_matmul_grouped(inj: CompiledInjector, ia: torch.Tensor, ib: torch.Tensor, *,
                                 schedule: str | None = None) -> torch.Tensor:
    """ia (G, M, K), ib (G, K, N) int32 operand indices -> (G, M, N) int32,
    one independent product per group (the activation x activation sites)."""
    if ia.dim() != 3 or ib.dim() != 3 or ia.shape[0] != ib.shape[0]:
        raise ValueError(f"grouped replay takes ia (G, M, K) and ib (G, K, N) with matching "
                         f"G, got {tuple(ia.shape)} / {tuple(ib.shape)}")
    check_accumulation_bound(inj, ia.shape[-1], schedule=schedule)
    return inject_replay_int32(inj, ia.contiguous(), ib.contiguous())
