"""Whole-multiplier branch-and-bound / beam search over cell assignments.

The greedy composition in ``reduction.build_schedule`` threads the running
expected error through per-column Fig. 3 solves, committing to each column's
local optimum before the next column is seen.  This module searches the
*joint* space instead: at every DSE column the branch set is that column's
exact achievable-error profile (``column.column_profile``) and the objective
is the |expected error| of the whole multiplier.

Two structural facts make the joint search tractable:

  * **Shape invariance** — column heights per stage are choice-independent:
    every full adder consumes three same-weight bits and emits one sum (at
    ``p``) plus one carry (at ``p+1``) whatever its type, and the HA /
    pass-through remainder rule depends only on ``height mod 3``.  The
    reduction *shape* (which columns reduce at which stage, with how many
    FAs, in which region) is therefore compiled once per design point
    (``compile_shape``); only the posibit/negabit splits — and hence each
    column's achievable error profile — depend on earlier choices.
  * **Admissible suffix bounds** — one FA changes the expected multiplier
    error by at most ``1/2 * 2^p``, so suffix sums of ``n_fa * 2^p / 2``
    over the remaining shape events lower-bound the best achievable |final
    error| from any node (Fig. 3's bound 1 lifted to the whole multiplier).

``search_assignments`` always runs a width-bounded beam pass (exact
``Fraction`` bookkeeping, deduplicated states) and then an exact DFS pass
capped by ``max_nodes`` whose pruning is seeded with the beam incumbents;
when the DFS exhausts the tree the returned optimum is provably optimal
and ``complete=True``.  ``greedy_assignment`` reproduces the per-column
Fig. 3 composition of ``reduction.build_schedule`` decision for decision —
the parity anchor for the export round-trip.

A copy of the JAX package's ``core/dse/multiplier.py`` (pure Python over
``Fraction``s); the parity tests hold its choices to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache

from .. import ppgen
from ..cells import output_polarity
from . import column as column_mod

MAX_STEP = column_mod.MAX_ABS_STEP  # max |avg err| one FA can contribute


@dataclasses.dataclass(frozen=True)
class ShapeEvent:
    """One column reduction of one stage (choice-independent skeleton)."""

    stage: int
    p: int            # column weight 2**p
    height: int       # bits entering the column this stage
    n_fa: int         # height // 3 full adders consumed here
    region: str       # "exact" | "approx" | "border"
    first_of_stage: bool

    @property
    def decision(self) -> bool:
        """True when the DSE actually chooses cells here."""
        return self.region != "exact" and self.n_fa > 0


@dataclasses.dataclass(frozen=True)
class ColumnChoice:
    """Recorded decision: the cells assigned to one column of one stage."""

    stage: int
    p: int
    pos_cnt: int
    neg_cnt: int
    cells: tuple[tuple[str, int, int], ...]


@dataclasses.dataclass(frozen=True)
class MultiplierAssignment:
    """A full-multiplier cell assignment for one ``(n_digits, border)``.

    ``choices`` covers exactly the decision events (approx/border columns
    with at least one FA) in processing order; exact-region and remainder
    cells are reproduced deterministically by ``reduction.build_schedule``.
    ``expected_error`` is the exact accumulated expected multiplier error,
    bit-identical to ``materialize(a).expected_error`` (asserted on export).
    """

    n_digits: int
    border: int | None
    choices: tuple[ColumnChoice, ...]
    expected_error: Fraction
    nodes: int
    complete: bool  # True when the exact DFS exhausted the search tree

    def tag(self) -> str:
        b = "exact" if self.border is None else f"b{self.border}"
        return f"dse_{self.n_digits}d_{b}_e{float(self.expected_error):+.3g}"


def initial_columns(n_digits: int) -> dict[int, tuple[int, int]]:
    """Partial-product column splits: ``{position: (pos_cnt, neg_cnt)}``."""
    layout = ppgen.build_pp_layout(n_digits)
    cols: dict[int, tuple[int, int]] = {}
    for p, pol in zip(layout.position.tolist(), layout.polarity.tolist()):
        pc, nc = cols.get(p, (0, 0))
        cols[p] = (pc + (pol == 0), nc + (pol == 1))
    return cols


@lru_cache(maxsize=None)
def compile_shape(n_digits: int, border: int | None) -> tuple[ShapeEvent, ...]:
    """The choice-independent reduction skeleton of a design point."""
    cols = {p: pc + nc for p, (pc, nc) in initial_columns(n_digits).items()}
    events: list[ShapeEvent] = []
    stage = 0
    while any(h > 2 for h in cols.values()):
        nxt: dict[int, int] = {}
        first = True
        for p in sorted(cols):
            h = cols[p]
            if h == 0:
                continue
            if h == 1:
                nxt[p] = nxt.get(p, 0) + 1
                continue
            if border is None or p > border:
                region = "exact"
            elif p == border:
                region = "border"
            else:
                region = "approx"
            n_fa = h // 3
            rem = h - 3 * n_fa
            events.append(ShapeEvent(stage, p, h, n_fa, region, first))
            first = False
            nxt[p] = nxt.get(p, 0) + n_fa + (1 if rem >= 1 else 0)
            nxt[p + 1] = nxt.get(p + 1, 0) + n_fa + (1 if rem == 2 else 0)
        cols = nxt
        stage += 1
    return tuple(events)


def _suffix_bounds(events: tuple[ShapeEvent, ...]) -> list[Fraction]:
    """``suffix[i]`` = max |expected-error change| events ``i..`` can apply."""
    suffix = [Fraction(0)] * (len(events) + 1)
    for i in range(len(events) - 1, -1, -1):
        step = Fraction(0)
        if events[i].region != "exact":
            step = MAX_STEP * events[i].n_fa * (1 << events[i].p)
        suffix[i] = suffix[i + 1] + step
    return suffix


def _exact_cells(pos: int, neg: int) -> tuple[tuple[str, int, int], ...]:
    """Exact-region policy of ``reduction.build_schedule``: triples, posibits first."""
    out = []
    while pos + neg >= 3:
        dp = min(3, pos)
        dn = 3 - dp
        out.append(("FA", dp, dn))
        pos -= dp
        neg -= dn
    return tuple(out)


def _add(nxt: dict[int, tuple[int, int]], p: int, pol: int) -> None:
    pc, nc = nxt.get(p, (0, 0))
    nxt[p] = (pc + (pol == 0), nc + (pol == 1))


def _apply_column(
    nxt: dict[int, tuple[int, int]], p: int, pos: int, neg: int,
    cells: tuple[tuple[str, int, int], ...],
) -> None:
    """Mutate ``nxt`` with the outputs of ``cells`` + HA/pass remainder.

    Mirrors the count-level effect of one column body of
    ``reduction.build_schedule`` (cell outputs, then exact HA on a 2-bit
    remainder, then pass-through of a single leftover bit).
    """
    for _name, dp, dn in cells:
        spol, cpol = output_polarity(3, dn)
        _add(nxt, p, int(spol))
        _add(nxt, p + 1, int(cpol))
        pos -= dp
        neg -= dn
    if pos < 0 or neg < 0:
        raise AssertionError("cell assignment over-consumes a polarity")
    rem = pos + neg
    if rem == 2:
        spol, cpol = output_polarity(2, neg)
        _add(nxt, p, int(spol))
        _add(nxt, p + 1, int(cpol))
    elif rem == 1:
        _add(nxt, p, 0 if pos else 1)
    elif rem != 0:
        raise AssertionError("column remainder exceeds 2 bits")


def _boundary(
    cols: dict[int, tuple[int, int]], nxt: dict[int, tuple[int, int]]
) -> tuple[dict[int, tuple[int, int]], dict[int, tuple[int, int]]]:
    """Stage boundary: untouched (height <= 1) columns pass through."""
    merged = dict(nxt)
    for p, (pc, nc) in cols.items():
        mc, mn = merged.get(p, (0, 0))
        merged[p] = (mc + pc, mn + nc)
    return merged, {}


def _pop(cols: dict, p: int) -> tuple[dict, int, int]:
    new_cols = dict(cols)
    pos, neg = new_cols.pop(p)
    return new_cols, pos, neg


class _KBest:
    """Bounded set of the k best distinct leaves by (|err|, err, choices)."""

    def __init__(self, k: int):
        self.k = k
        self.items: list[tuple[Fraction, Fraction, tuple[ColumnChoice, ...]]] = []

    def offer(self, e_abs: Fraction, choices: tuple[ColumnChoice, ...]) -> None:
        key = (abs(e_abs), e_abs, choices)
        if any(c == choices for _, _, c in self.items):
            return
        self.items.append(key)
        # ties beyond (|err|, err) keep insertion order (deterministic: beam
        # ranking, then greedy, then DFS exploration order)
        self.items.sort(key=lambda t: (t[0], t[1]))
        del self.items[self.k:]

    @property
    def worst(self) -> Fraction | None:
        return self.items[-1][0] if len(self.items) == self.k else None


def _beam(
    events: tuple[ShapeEvent, ...],
    init_cols: dict[int, tuple[int, int]],
    k: int,
    beam_width: int,
    branch_cap: int,
) -> tuple[_KBest, int]:
    """Width-bounded forward pass; returns k best leaves + states expanded."""
    # state: (e_abs, cols, nxt, choices)
    states = [(Fraction(0), dict(init_cols), {}, ())]
    nodes = 0
    for i, ev in enumerate(events):
        if ev.first_of_stage and i > 0:
            states = [(e, *_boundary(c, x), ch) for e, c, x, ch in states]
        new_states = []
        for e_abs, cols, nxt, choices in states:
            cols2, pos, neg = _pop(cols, ev.p)
            if pos + neg != ev.height:
                raise AssertionError("shape/state height mismatch")
            if not ev.decision:
                cells = _exact_cells(pos, neg) if ev.region == "exact" else ()
                nxt2 = dict(nxt)
                _apply_column(nxt2, ev.p, pos, neg, cells)
                new_states.append((e_abs, cols2, nxt2, choices))
                nodes += 1
                continue
            profile = column_mod.column_profile(pos, neg, ev.region == "border")
            w = 1 << ev.p
            ranked = sorted(profile.items(), key=lambda kv: (abs(e_abs + kv[0] * w), kv[0]))
            for s, cells in ranked[:branch_cap]:
                nxt2 = dict(nxt)
                _apply_column(nxt2, ev.p, pos, neg, cells)
                choice = ColumnChoice(ev.stage, ev.p, pos, neg, cells)
                new_states.append((e_abs + s * w, cols2, nxt2, choices + (choice,)))
                nodes += 1
        # Dedup identical futures (same error + same splits): choices differ
        # only in the past, so keeping the best-ranked one loses nothing.
        seen = set()
        deduped = []
        for st in sorted(new_states, key=lambda t: (abs(t[0]), t[0])):
            sig = (st[0], tuple(sorted(st[1].items())), tuple(sorted(st[2].items())))
            if sig in seen:
                continue
            seen.add(sig)
            deduped.append(st)
        states = deduped[:beam_width]
    best = _KBest(k)
    for e_abs, _cols, _nxt, choices in states:
        best.offer(e_abs, choices)
    return best, nodes


def _dfs(
    events: tuple[ShapeEvent, ...],
    init_cols: dict[int, tuple[int, int]],
    suffix: list[Fraction],
    best: _KBest,
    max_nodes: int,
) -> tuple[int, bool]:
    """Exact DFS with admissible k-best pruning; returns (nodes, complete)."""
    nodes = 0
    aborted = False

    def rec(i, cols, nxt, e_abs, choices):
        nonlocal nodes, aborted
        if aborted:
            return
        nodes += 1
        if nodes > max_nodes:
            aborted = True
            return
        if i == len(events):
            best.offer(e_abs, choices)
            return
        worst = best.worst
        if worst is not None and abs(e_abs) - suffix[i] > worst:
            return  # admissible: remaining events cannot recover the deficit
        ev = events[i]
        if ev.first_of_stage and i > 0:
            cols, nxt = _boundary(cols, nxt)
        cols2, pos, neg = _pop(cols, ev.p)
        if not ev.decision:
            cells = _exact_cells(pos, neg) if ev.region == "exact" else ()
            nxt2 = dict(nxt)
            _apply_column(nxt2, ev.p, pos, neg, cells)
            rec(i + 1, cols2, nxt2, e_abs, choices)
            return
        profile = column_mod.column_profile(pos, neg, ev.region == "border")
        w = 1 << ev.p
        ranked = sorted(profile.items(), key=lambda kv: (abs(e_abs + kv[0] * w), kv[0]))
        for s, cells in ranked:
            nxt2 = dict(nxt)
            _apply_column(nxt2, ev.p, pos, neg, cells)
            choice = ColumnChoice(ev.stage, ev.p, pos, neg, cells)
            rec(i + 1, cols2, nxt2, e_abs + s * w, choices + (choice,))

    rec(0, dict(init_cols), {}, Fraction(0), ())
    return nodes, not aborted


def greedy_assignment(n_digits: int, border: int | None) -> MultiplierAssignment:
    """The per-column Fig. 3 composition, decision-for-decision identical to
    ``reduction.build_schedule``'s built-in policy (parity anchor)."""
    events = compile_shape(n_digits, border)
    cols = dict(initial_columns(n_digits))
    nxt: dict[int, tuple[int, int]] = {}
    e_abs = Fraction(0)
    nodes = 0
    choices: list[ColumnChoice] = []
    for i, ev in enumerate(events):
        if ev.first_of_stage and i > 0:
            cols, nxt = _boundary(cols, nxt)
        cols, pos, neg = _pop(cols, ev.p)
        if not ev.decision:
            cells = _exact_cells(pos, neg) if ev.region == "exact" else ()
        else:
            res = column_mod.assign_column(
                pos, neg, e_abs / Fraction(1 << ev.p),
                allow_exact_fa=ev.region == "border",
            )
            nodes += res.nodes
            cells = tuple(res.cells)
            choices.append(ColumnChoice(ev.stage, ev.p, pos, neg, cells))
            e_abs = res.err * (1 << ev.p)
        _apply_column(nxt, ev.p, pos, neg, cells)
    return MultiplierAssignment(
        n_digits, border, tuple(choices), e_abs, nodes, complete=False)


def search_assignments(
    n_digits: int,
    border: int | None,
    *,
    k: int = 3,
    beam_width: int = 64,
    branch_cap: int = 6,
    max_nodes: int = 100_000,
    score_hook=None,
    pool: int | None = None,
) -> list[MultiplierAssignment]:
    """The ``k`` best whole-multiplier assignments by |expected error|.

    Beam pass first (always terminates; exact bookkeeping), then an exact
    DFS seeded with the beam incumbents and capped at ``max_nodes``; if the
    DFS exhausts the tree, ``[0]`` is the provable optimum and every result
    carries ``complete=True``.  Results are sorted by (|error|, error) and
    are pairwise-distinct assignments.

    ``score_hook`` re-ranks by a MEASURED criterion: the analytic |expected
    error| only tracks the error mean, so two assignments with equal means
    can have very different variance.  When given, the search keeps a wider
    analytic pool (``pool``, default ``3 * k``), calls
    ``score_hook(assignments) -> sequence of floats`` (lower is better —
    e.g. Monte-Carlo ``std_ed`` via :func:`repro.core.dse.pareto.
    measured_score_hook`), and returns the ``k`` best by (score, |error|).
    """
    events = compile_shape(n_digits, border)
    init_cols = initial_columns(n_digits)
    keep = k if score_hook is None else max(pool or 3 * k, k)
    if not any(ev.decision for ev in events):
        return [MultiplierAssignment(n_digits, border, (), Fraction(0), 0, True)]
    suffix = _suffix_bounds(events)
    best, beam_nodes = _beam(events, init_cols, keep, beam_width, branch_cap)
    # The greedy incumbent is free and often optimal — seed it too.
    greedy = greedy_assignment(n_digits, border)
    best.offer(greedy.expected_error, greedy.choices)
    dfs_nodes, complete = _dfs(events, init_cols, suffix, best, max_nodes)
    nodes = beam_nodes + greedy.nodes + dfs_nodes
    results = [
        MultiplierAssignment(n_digits, border, choices, e_abs, nodes, complete)
        for _abs_e, e_abs, choices in best.items
    ]
    if score_hook is not None:
        scores = list(score_hook(results))
        if len(scores) != len(results):
            raise ValueError(
                f"score_hook returned {len(scores)} scores for "
                f"{len(results)} assignments")
        order = sorted(
            range(len(results)),
            key=lambda j: (scores[j], abs(results[j].expected_error),
                           results[j].expected_error))
        results = [results[j] for j in order[:k]]
    return results
