"""Partial-product generation for the radix-16 MRSD multiplier (paper §II.B).

Every bit of X multiplies every bit of Y; the product bit lands at position
``p1 + p2`` and its polarity is the "product" of the input polarities.
With inverted negabit storage (value = stored - 1) the single-gate forms are:

  pos(x) * pos(y): value x*y          -> posibit, stored = x AND y
  pos(x) * neg(y): value x*(y-1)      -> negabit, stored = NOT(x) OR y
  neg(x) * pos(y): value (x-1)*y      -> negabit, stored = NOT(y) OR x
  neg(x) * neg(y): value (x-1)*(y-1)  -> posibit, stored = NOR(x, y)

(the paper's §II.B identities are the same one-gate-per-PP structure under
its own storage convention; ours is property-tested for exactness).

Operand bits are flattened as: indices [0, 4N) = posibits (position j),
indices [4N, 5N) = negabits (negabit k at position 4(k+1)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import mrsd

# gate types
G_AND = 0   # pos*pos
G_ORN_X = 1  # pos(x)*neg(y): !x | y
G_ORN_Y = 2  # neg(x)*pos(y): !y | x
G_NOR = 3   # neg*neg


@dataclasses.dataclass(frozen=True)
class PPLayout:
    """Static partial-product wiring for an N x N digit MRSD multiply."""

    n_digits: int
    position: np.ndarray  # (n_pp,) int64 column of each PP bit
    polarity: np.ndarray  # (n_pp,) uint8: 0 posibit, 1 negabit
    gate: np.ndarray      # (n_pp,) uint8 gate type
    x_idx: np.ndarray     # (n_pp,) index into flattened X bits
    y_idx: np.ndarray     # (n_pp,) index into flattened Y bits

    @property
    def n_pp(self) -> int:
        return int(self.position.shape[0])

    @property
    def n_columns(self) -> int:
        return int(self.position.max()) + 1


def flatten_operand_bits(digits: np.ndarray) -> np.ndarray:
    """(..., N) digits -> (..., 5N) flat stored bits (posibits then negabits)."""
    pos, neg = mrsd.digits_to_bits(digits)
    return np.concatenate([pos, neg], axis=-1)


def operand_bit_meta(n_digits: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions, polarities) for the 5N flattened operand bits."""
    positions = np.concatenate([mrsd.pos_positions(n_digits), mrsd.neg_positions(n_digits)])
    polarities = np.concatenate([
        np.zeros(4 * n_digits, dtype=np.uint8),
        np.ones(n_digits, dtype=np.uint8),
    ])
    return positions, polarities


def build_pp_layout(n_digits: int) -> PPLayout:
    """All 25*N^2 partial-product bits of an N x N digit multiply."""
    positions, polarities = operand_bit_meta(n_digits)
    nb = positions.shape[0]  # 5N
    xi, yi = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    xi = xi.ravel()
    yi = yi.ravel()
    px = positions[xi]
    py = positions[yi]
    gx = polarities[xi].astype(np.int64)
    gy = polarities[yi].astype(np.int64)
    pp_pos = px + py
    pp_pol = (gx ^ gy).astype(np.uint8)  # neg*neg and pos*pos are posibits
    gate = np.where(
        (gx == 0) & (gy == 0), G_AND,
        np.where((gx == 0) & (gy == 1), G_ORN_X,
                 np.where((gx == 1) & (gy == 0), G_ORN_Y, G_NOR)),
    ).astype(np.uint8)
    return PPLayout(n_digits, pp_pos.astype(np.int64), pp_pol, gate, xi, yi)


def eval_pp_bits(layout: PPLayout, xbits: np.ndarray, ybits: np.ndarray) -> np.ndarray:
    """Stored values of all PP bits. xbits/ybits: (..., 5N) uint8 -> (..., n_pp)."""
    x = xbits[..., layout.x_idx].astype(np.uint8)
    y = ybits[..., layout.y_idx].astype(np.uint8)
    g = layout.gate
    out = np.empty_like(x)
    m = g == G_AND
    out[..., m] = x[..., m] & y[..., m]
    m = g == G_ORN_X
    out[..., m] = (1 - x[..., m]) | y[..., m]
    m = g == G_ORN_Y
    out[..., m] = (1 - y[..., m]) | x[..., m]
    m = g == G_NOR
    out[..., m] = (1 - x[..., m]) & (1 - y[..., m])
    return out
