"""Plain PyTorch version of the circuit-replay kernel.

The outer-product replay of the JAX package's
``numerics/injection.py::injected_matmul_int`` (without its guard, which
``ops.py`` applies): the B side is lane-packed
once (``CompiledInjector.pack_weights``, 32 columns per word), the A side
replays as full-word masks against it, and products are summed in int32
over row and K chunks sized by ``plan_chunks``, so at most ``max_pairs``
operand pairs are replayed at a time.  The kernel wrapper runs it for CPU
tensors, the tests hold it against the JAX package, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.engine import _LANE_BITS, CompiledInjector

# Upper bound on operand pairs replayed per chunk (memory knob: the replay
# holds about 302 int32 words per 32 pairs).
MAX_PAIRS_PER_CHUNK = 1 << 18


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def plan_chunks(rows: int, k: int, n_words: int, max_pairs: int) -> tuple[int, int]:
    """(row_chunk, k_chunk) bounding the pairs replayed per chunk.

    The largest divisors of ``rows``/``k`` with ``row_chunk * k_chunk *
    n_words * 32 <= max_pairs`` (K first).  The floor is one row x one k,
    ``n_words * 32`` pairs.
    """
    budget = max(1, max_pairs // _LANE_BITS)  # words per chunk
    kc = _largest_divisor_leq(k, max(1, budget // n_words))
    rc = _largest_divisor_leq(rows, max(1, budget // (kc * n_words)))
    return rc, kc


def replay_matmul_ref(inj: CompiledInjector, ia: torch.Tensor, ib: torch.Tensor, *,
                      max_pairs: int = MAX_PAIRS_PER_CHUNK) -> torch.Tensor:
    """``out[.., m, n] = sum_k AMR(ia[.., m, k], ib[k, n])`` in int32.

    ``ia``: (..., M, K) and ``ib``: (K, N) int operand indices (value +
    128), or a grouped ``ia`` (G, M, K) with ``ib`` (G, K, N), one
    independent product per group.  Returns (..., M, N) int32.
    """
    if ib.dim() == 3:
        return torch.stack([replay_matmul_ref(inj, ia[g], ib[g], max_pairs=max_pairs)
                            for g in range(ib.shape[0])])
    *lead, M, K = ia.shape
    N = ib.shape[-1]
    rows = math.prod(lead) * M
    ia2 = ia.reshape(rows, K)
    yw = inj.pack_weights(ib)
    n_words = yw.shape[-1]
    rc, kc = plan_chunks(rows, K, n_words, max_pairs)
    out = torch.empty((rows, n_words * _LANE_BITS), dtype=torch.int32, device=ia.device)
    for r0 in range(0, rows, rc):
        acc = torch.zeros((rc, n_words * _LANE_BITS), dtype=torch.int32, device=ia.device)
        for k0 in range(0, K, kc):
            prods = inj.products_outer(inj.operand_masks(ia2[r0:r0 + rc, k0:k0 + kc]),
                                       yw[k0:k0 + kc])
            acc += prods.sum(dim=1, dtype=torch.int32)
        out[r0:r0 + rc] = acc
    return out[:, :N].reshape(*lead, M, N)
