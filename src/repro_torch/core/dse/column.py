"""Column-local DSE solvers: Fig. 3 branch-and-bound + an exact DP profile.

A copy of the JAX package's ``core/dse/column.py``.

``assign_column`` is the faithful implementation of the paper's Fig. 3
``DSE_FA_Assign`` with two documented fixes (see DESIGN.md):

  * Fig. 3 line 1 reads ``FA_cnt = (pos_cnt + neg_cnt) % 3`` — a modulus
    cannot count full adders; we use ``(pos_cnt + neg_cnt) // 3`` (triples
    consumed), the remainder being handled by an exact HA (2 bits) or a
    pass-through (1 bit) exactly as in the multiplier structure (Fig. 1.b).
  * The paper's bounds 2/3 prune on the *sign* of the running error when a
    single polarity remains; when only one polarity remains the assignment
    is *forced*, so we evaluate the forced tail directly — equivalent
    effect, but guaranteed admissible (never prunes the optimum; property-
    tested against brute force).

Bound 1 is the standard admissible bound: each remaining FA changes the
expected error by at most ``max |avg_err| = 0.5``, so a branch whose best
achievable |final error| already exceeds the incumbent is cut.

Branches per node (Fig. 3 lines 13-24): FA_PP (3 pos), FA_PN1/FA_PN2
(2 pos + 1 neg), FA_NP1/FA_NP2 (1 pos + 2 neg), FA_NN (3 neg), plus the
exact FA (any feasible polarity mix, zero error) when assigning the border
column.

``column_profile`` is the complementary *exact dynamic program*: for a given
``(pos_cnt, neg_cnt)`` it enumerates every achievable total column error
(errors are quarter-multiples, so the state space is tiny) with one
canonical representative cell list per value.  It serves three roles:

  * a brute-force-equivalent oracle that stays cheap on tall columns, so
    optimality of ``assign_column`` is property-testable far beyond the
    exponential ``brute_force_column``'s reach,
  * the branch generator of the whole-multiplier search (multiplier.py):
    a column's decision space IS its achievable-error profile,
  * ``assign_column_topk``, the ranked k-best used to seed diverse
    full-multiplier candidates for the measured Pareto sweep.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache

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


def brute_force_column(
    pos_cnt: int, neg_cnt: int, err_in: float | Fraction = 0, *, allow_exact_fa: bool = False
) -> Fraction:
    """Exhaustive minimum |final error| — oracle for property tests."""
    err_in = Fraction(err_in).limit_denominator(1 << 20)
    branches = _APPROX_BRANCHES + (_EXACT_BRANCHES if allow_exact_fa else [])
    best = [None]

    def rec(p, n, err):
        if (p + n) // 3 == 0:
            a = abs(err)
            if best[0] is None or a < best[0]:
                best[0] = a
            return
        for name, dp, dn, de in branches:
            if p >= dp and n >= dn:
                rec(p - dp, n - dn, err + de)

    rec(pos_cnt, neg_cnt, err_in)
    return best[0]


# ---------------------------------------------------------------------------
# exact achievable-error profile (dynamic program)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def column_profile(
    pos_cnt: int, neg_cnt: int, allow_exact_fa: bool = False
) -> dict[Fraction, tuple[tuple[str, int, int], ...]]:
    """Every achievable total column error -> one canonical cell assignment.

    Exhaustive-equivalent by construction: the DP unions branch outcomes over
    the same branch set as ``brute_force_column``, but keyed by error sum —
    cell errors are quarter-multiples in [-1/2, +1/2] and a column consumes
    ``(pos+neg)//3`` triples, so the profile has O(height) entries instead of
    O(6^height) leaves.  The representative per error value is the
    lexicographically smallest sorted cell tuple (deterministic across runs).
    Callers must not mutate the returned dict (it is cached).
    """
    if (pos_cnt + neg_cnt) // 3 == 0:
        return {Fraction(0): ()}
    branches = _APPROX_BRANCHES + (_EXACT_BRANCHES if allow_exact_fa else [])
    out: dict[Fraction, tuple] = {}
    for name, dp, dn, de in branches:
        if pos_cnt >= dp and neg_cnt >= dn:
            sub = column_profile(pos_cnt - dp, neg_cnt - dn, allow_exact_fa)
            for s, cells in sub.items():
                total = de + s
                cand = tuple(sorted(cells + ((name, dp, dn),)))
                if total not in out or cand < out[total]:
                    out[total] = cand
    return out


def assign_column_topk(
    pos_cnt: int,
    neg_cnt: int,
    err_in: float | Fraction = 0,
    *,
    k: int = 4,
    allow_exact_fa: bool = False,
) -> list[DSEResult]:
    """The ``k`` best column assignments ranked by |err_in + column error|.

    ``[0]`` achieves the same optimum as ``assign_column`` (both are exact);
    the tail seeds alternative whole-multiplier candidates for the measured
    Pareto sweep.  Ties rank the more negative error first, matching the
    paper's preference for designs whose mean error straddles zero.
    """
    err_in = Fraction(err_in).limit_denominator(1 << 20)
    profile = column_profile(pos_cnt, neg_cnt, allow_exact_fa)
    ranked = sorted(profile.items(), key=lambda kv: (abs(err_in + kv[0]), kv[0]))
    return [
        DSEResult(list(cells), err_in + s, len(profile))
        for s, cells in ranked[:k]
    ]
