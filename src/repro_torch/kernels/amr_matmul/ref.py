"""Plain PyTorch versions of the AMR matmul kernels.

The kernel wrappers (``kernel.py``) run these for CPU tensors; the tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  They materialise the gathered
(..., M, k, N) products, so they run in K chunks of bounded size.
"""
from __future__ import annotations

import torch

_MAX_ELEMS = 1 << 25  # gathered elements per K chunk


def _k_step(per_k: int) -> int:
    return max(1, _MAX_ELEMS // max(per_k, 1))


def lut_matmul_ref(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """int8 (..., M, K) @ (..., K, N) -> int32 sum_k table[a+128, b+128].

    Leading dims broadcast.  Accumulates in int64, so it is exact for any
    K; the result is cast to int32 (the callers bound K * max|product|).
    """
    flat = table.reshape(-1).to(torch.int64)
    ia = a.to(torch.int64) + 128
    ib = b.to(torch.int64) + 128
    M, K = a.shape[-2:]
    N = b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    acc = torch.zeros((*lead, M, N), dtype=torch.int64, device=a.device)
    step = _k_step(M * N * max(1, lead.numel()))
    for k0 in range(0, K, step):
        idx = ia[..., :, k0:k0 + step, None] * 256 + ib[..., None, k0:k0 + step, :]
        acc += flat[idx].sum(dim=-2)
    return acc.to(torch.int32)


def lowrank_matmul_ref(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ (K, N) -> float32 A@B + U[A] . V[B], the same dense math
    as the JAX package's ``ref_lowrank_int8`` (f32 accumulation order differs).

    Row-independent, as the CUDA kernel is: each row's float32 products are
    separate calls of one shape, so a row's sums do not depend on how many
    rows share the call.  The V gather is made once per K chunk for all rows.
    """
    M, K = a.shape
    N = b.shape[1]
    bf = b.float()
    rows = [a[i:i + 1].float() @ bf for i in range(M)]
    ia = a.to(torch.int64) + 128
    ib = b.to(torch.int64) + 128
    step = _k_step(N * u.shape[1])  # independent of M: a row's sum order is fixed
    for k0 in range(0, K, step):
        ua = u[ia[:, k0:k0 + step]]          # (M, k, r)
        vb = v[ib[k0:k0 + step]]             # (k, N, r)
        for i in range(M):
            rows[i] += torch.einsum("mkr,knr->mn", ua[i:i + 1], vb)
    return torch.cat(rows) if rows else a.new_empty((0, N), dtype=torch.float32)
