"""Fig. 3 branch-and-bound column assignment (``assign_column``).

Copied from the JAX package's ``core/dse/column.py``: the faithful
implementation of the paper's ``DSE_FA_Assign`` with its two documented
fixes (``FA_cnt = (pos_cnt + neg_cnt) // 3`` triples, and forced
single-polarity tails evaluated directly instead of pruned by sign).
Bound 1 prunes a branch whose best achievable |final error| already
exceeds the incumbent: each remaining FA moves the expected error by at
most ``max |avg_err| = 1/2``.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

from ..cells import CELLS

# (cell name, pos consumed, neg consumed, avg err as Fraction)
_Q = Fraction(1, 4)
_APPROX_BRANCHES = [
    ("FA_PP", 3, 0, Fraction(CELLS["FA_PP"].avg_err).limit_denominator(4)),
    ("FA_PN1", 2, 1, Fraction(CELLS["FA_PN1"].avg_err).limit_denominator(4)),
    ("FA_PN2", 2, 1, Fraction(CELLS["FA_PN2"].avg_err).limit_denominator(4)),
    ("FA_NP1", 1, 2, Fraction(CELLS["FA_NP1"].avg_err).limit_denominator(4)),
    ("FA_NP2", 1, 2, Fraction(CELLS["FA_NP2"].avg_err).limit_denominator(4)),
    ("FA_NN", 0, 3, Fraction(CELLS["FA_NN"].avg_err).limit_denominator(4)),
]
_EXACT_BRANCHES = [  # exact FA on any feasible polarity mix (border column only)
    ("FA", 3, 0, Fraction(0)),
    ("FA", 2, 1, Fraction(0)),
    ("FA", 1, 2, Fraction(0)),
    ("FA", 0, 3, Fraction(0)),
]
MAX_ABS_STEP = Fraction(1, 2)  # max |avg err| any single FA can contribute


@dataclasses.dataclass
class DSEResult:
    cells: list[tuple[str, int, int]]  # (cell name, pos consumed, neg consumed)
    err: Fraction                       # err_in + sum of assigned cell errors
    nodes: int                          # search-tree nodes visited (reporting)


def assign_column(
    pos_cnt: int,
    neg_cnt: int,
    err_in: float | Fraction = 0,
    *,
    allow_exact_fa: bool = False,
) -> DSEResult:
    """Optimal FA assignment for one column of one PPR stage.

    Consumes ``(pos_cnt + neg_cnt) // 3`` triples; minimises
    ``|err_in + sum(avg_err of chosen cells)|``. Leftover bits (< 3) are the
    caller's to pass through / HA. Returns the chosen cells in consumption
    order.
    """
    err_in = Fraction(err_in).limit_denominator(1 << 20)
    n_fa = (pos_cnt + neg_cnt) // 3
    branches = _APPROX_BRANCHES + (_EXACT_BRANCHES if allow_exact_fa else [])

    best_abs: list[Fraction] = [abs(err_in) + MAX_ABS_STEP * n_fa + 1]
    best_cells: list[list] = [[]]
    nodes = [0]
    memo: dict[tuple, Fraction] = {}

    def rec(p: int, n: int, err: Fraction, chosen: list) -> None:
        nodes[0] += 1
        remaining = (p + n) // 3
        if remaining == 0:
            if abs(err) < best_abs[0]:
                best_abs[0] = abs(err)
                best_cells[0] = list(chosen)
            return
        # Bound 1: best achievable |final error| from here.
        floor = abs(err) - MAX_ABS_STEP * remaining
        if floor > 0 and floor >= best_abs[0]:
            return
        # Dominance memo: if we reached (p, n) before with the same error,
        # the subtree is identical — skip re-expansion unless it could win.
        key = (p, n, err)
        if key in memo:
            return
        memo[key] = err
        # Forced tails (paper bounds 2/3, made exact): single polarity left.
        # Only valid when the exact FA is not a branch option (non-border
        # columns) — with exact FAs allowed nothing is forced.
        if allow_exact_fa:
            pass
        elif n == 0 and p >= 3:
            # all remaining must be FA_PP
            e = err
            tail = []
            k = p
            while k >= 3:
                e += _APPROX_BRANCHES[0][3]
                tail.append(("FA_PP", 3, 0))
                k -= 3
            if abs(e) < best_abs[0]:
                best_abs[0] = abs(e)
                best_cells[0] = list(chosen) + tail
            return
        elif p == 0 and n >= 3:
            e = err
            tail = []
            k = n
            while k >= 3:
                e += _APPROX_BRANCHES[5][3]
                tail.append(("FA_NN", 0, 3))
                k -= 3
            if abs(e) < best_abs[0]:
                best_abs[0] = abs(e)
                best_cells[0] = list(chosen) + tail
            return
        for name, dp, dn, de in branches:
            if p >= dp and n >= dn and (p - dp + n - dn) >= 0:
                chosen.append((name, dp, dn))
                rec(p - dp, n - dn, err + de, chosen)
                chosen.pop()

    rec(pos_cnt, neg_cnt, err_in, [])
    total = err_in + sum(
        Fraction(CELLS[c].avg_err).limit_denominator(4) for c, _, _ in best_cells[0]
    )
    return DSEResult(best_cells[0], total, nodes[0])
