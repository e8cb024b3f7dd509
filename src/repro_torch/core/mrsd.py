"""Radix-16 maximally-redundant signed-digit (MRSD) number system.

Representation (paper §II.A, encoding of Jaberipur–Parhami [11]):

  * An N-digit operand has digits ``d_k`` in ``[-16, 15]`` and value
    ``sum_k d_k * 16**k``.
  * Each digit is 5 bits in 2's-complement: four *posibits* ``b0..b3``
    (values in {0,1}, weights ``2**(4k+i)``) and one *negabit* whose
    weight equals the LSB of the next digit, i.e. ``2**(4(k+1))``.
  * Negabits use the **inverted storage** convention of [11]: a negabit
    with stored bit ``s`` has arithmetic value ``s - 1`` (in {-1, 0}).
    Under this convention any three same-weight stored bits add with an
    ordinary full adder; only the *polarity interpretation* of the
    outputs changes with the number of negabit inputs (see cells.py).

Flat bit layout of an N-digit operand (used by ppgen/reduction):

  * posibits: index ``j`` in ``[0, 4N)``   -> position ``j``      (weight +2**j)
  * negabits: index ``k`` in ``[0, N)``    -> position ``4(k+1)`` (weight 2**{4(k+1)},
    value stored-1)

Value identity::

  X = sum_j  pos[j]  * 2**j  +  sum_k (neg[k] - 1) * 2**(4(k+1))

Dynamic range of N digits: ``[-16*(16**N - 1)//15, 16**N - 1]``
(N=2: [-272, 255] as quoted in the paper §IV.B).
"""
from __future__ import annotations

import numpy as np

RADIX = 16
BITS_PER_DIGIT = 4  # posibits per digit; +1 negabit
DIGIT_MIN = -16
DIGIT_MAX = 15


def pos_positions(n_digits: int) -> np.ndarray:
    """Bit position (log2 weight) of each posibit."""
    return np.arange(4 * n_digits, dtype=np.int64)


def neg_positions(n_digits: int) -> np.ndarray:
    """Bit position of each negabit (same weight as next digit's LSB)."""
    return 4 * (np.arange(n_digits, dtype=np.int64) + 1)


def min_value(n_digits: int) -> int:
    return -16 * (16**n_digits - 1) // 15


def max_value(n_digits: int) -> int:
    return 16**n_digits - 1


def encode(x, n_digits: int) -> np.ndarray:
    """Canonical MRSD encoding of integer(s) ``x`` into ``n_digits`` digits.

    LSD-first greedy: each digit is chosen congruent to the remainder mod 16,
    preferring the non-negative residue and falling back to ``residue - 16``
    when needed to keep the remaining value representable by the remaining
    digits (the bottom of the MRSD range requires negative digits).
    Accepts scalars or integer arrays; returns shape ``x.shape + (n_digits,)``.
    """
    x = np.asarray(x, dtype=np.int64)
    lo, hi = min_value(n_digits), max_value(n_digits)
    if np.any(x < lo) or np.any(x > hi):
        raise ValueError(f"value out of range [{lo}, {hi}] for {n_digits} digits")
    digits = np.zeros(x.shape + (n_digits,), dtype=np.int64)
    r = x.copy()
    for k in range(n_digits - 1):
        m = n_digits - 1 - k  # digits remaining after this one
        rem_lo, rem_hi = min_value(m), max_value(m)
        d_pos = r % 16  # numpy: non-negative residue
        r_pos = (r - d_pos) // 16
        use_neg = (r_pos > rem_hi) | (r_pos < rem_lo)
        d = np.where(use_neg, d_pos - 16, d_pos)
        digits[..., k] = d
        r = (r - d) // 16
    digits[..., n_digits - 1] = r
    if np.any(r < DIGIT_MIN) or np.any(r > DIGIT_MAX):
        raise ValueError("top digit out of [-16, 15]; value not representable")
    return digits


def decode(digits: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Value of digit array(s); float64 by default (8-digit products exceed int64)."""
    digits = np.asarray(digits)
    n = digits.shape[-1]
    w = (16.0 ** np.arange(n)).astype(np.float64)
    return (digits.astype(np.float64) * w).sum(-1).astype(dtype)


def digits_to_bits(digits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Digit array -> (posibits, stored negabits).

    digits: (..., N) in [-16, 15].
    Returns pos (..., 4N) uint8 and neg (..., N) uint8 where the negabit is
    stored inverted (stored 1 == arithmetic 0, stored 0 == arithmetic -1).
    """
    digits = np.asarray(digits, dtype=np.int64)
    if np.any(digits < DIGIT_MIN) or np.any(digits > DIGIT_MAX):
        raise ValueError("digit out of range [-16, 15]")
    n = digits.shape[-1]
    is_neg = (digits < 0).astype(np.int64)  # arithmetic negabit value is -is_neg
    b = digits + 16 * is_neg  # low nibble in [0, 15]
    shifts = np.arange(BITS_PER_DIGIT, dtype=np.int64)
    pos = ((b[..., :, None] >> shifts) & 1).astype(np.uint8)  # (..., N, 4)
    pos = pos.reshape(digits.shape[:-1] + (4 * n,))
    neg = (1 - is_neg).astype(np.uint8)  # inverted storage
    return pos, neg


def random_digits(rng: np.random.Generator, n_digits: int, batch: int) -> np.ndarray:
    """Uniform random digit vectors over the full redundant digit set [-16, 15].

    This is how the paper's Monte-Carlo inputs exercise both polarities
    (§IV: 50K/500K/1M random inputs).
    """
    return rng.integers(DIGIT_MIN, DIGIT_MAX + 1, size=(batch, n_digits), dtype=np.int64)
