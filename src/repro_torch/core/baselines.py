"""Approximate *binary* (BNS) multiplier baselines the paper compares against.

Functional (bit-accurate) models of three families from the paper's Fig. 4
comparison set, plus the exact BNS multiplier, so the comparison benchmark
is self-contained:

  * ``exact_mul``      — exact two's-complement multiply.
  * ``drum``           — DRUM(k) [15]: dynamic-range unbiased; keeps the k
                         leading bits from the MSB of |x|, forces the kept
                         LSB to 1 (unbiasing), multiplies, shifts back.
  * ``trunc_mul``      — LETAM-class [13] truncation: zeroes the low
                         (width - t) bits of each |operand| before
                         multiplying (simple truncation baseline).

All operate on int64 arrays of signed operands of a given bit width; cost
estimates reuse the calibrated CostModel basis with BNS structural counts
(see benchmarks/fig4_comparison.py).  A copy of the JAX package's
``core/baselines.py``.
"""
from __future__ import annotations

import numpy as np


def exact_mul(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.int64) * np.asarray(y, dtype=np.int64)


def _leading_bit(v: np.ndarray) -> np.ndarray:
    """floor(log2(v)) for v >= 1 (0 for v == 0)."""
    v = v.astype(np.uint64)
    out = np.zeros(v.shape, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        m = v >= (np.uint64(1) << np.uint64(shift))
        out[m] += shift
        v = np.where(m, v >> np.uint64(shift), v)
    return out


def drum(x: np.ndarray, y: np.ndarray, k: int) -> np.ndarray:
    """DRUM(k) dynamic-range unbiased approximate multiply (signed)."""
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    sign = np.sign(x) * np.sign(y)
    ax, ay = np.abs(x), np.abs(y)

    def approx_abs(v):
        lead = _leading_bit(np.maximum(v, 1))
        shift = np.maximum(lead - (k - 1), 0)
        kept = v >> shift
        kept = np.where(shift > 0, kept | 1, kept)  # unbias: set kept LSB
        return kept, shift

    kx, sx = approx_abs(ax)
    ky, sy = approx_abs(ay)
    return sign * ((kx * ky) << (sx + sy))


def trunc_mul(x: np.ndarray, y: np.ndarray, width: int, t: int) -> np.ndarray:
    """Truncation multiplier: keep top t bits of each |operand| of ``width`` bits."""
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    sign = np.sign(x) * np.sign(y)
    drop = max(width - 1 - t, 0)  # width-1 magnitude bits
    mask = ~((np.int64(1) << drop) - np.int64(1))
    return sign * ((np.abs(x) & mask) * (np.abs(y) & mask))


def mared(approx: np.ndarray, exact: np.ndarray) -> float:
    nz = exact != 0
    return float(np.mean(np.abs((approx[nz] - exact[nz]) / exact[nz])))
