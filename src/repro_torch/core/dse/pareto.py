"""Measured (error, energy) Pareto exploration over DSE candidates.

Analytic expected error ranks candidates inside the search, but the number
that matters for deployment is the *measured* Monte-Carlo error of the
exported schedule — the two can diverge because the analytic bound tracks
only the mean.  ``measure_candidates`` therefore replays seeded MC batches
through ``engine.compile_candidates`` on a ``device`` (``"cuda"`` unless
the caller names another): every candidate of a digit width (plus the
exact reference) replays one shared bit-packed operand chunk, moved to the
device once, and the per-candidate error metrics are accumulated exactly
on the host (split-integer error distances, the Table I protocol, in the
JAX package's chunk order, so the metrics have its bits).

``pareto_sweep`` composes the whole pipeline — search k candidates per
border, materialize, measure, cost — and flags the non-dominated
(error, energy) frontier per digit width.  ``select_border`` is the
application-facing wrapper: cheapest frontier design meeting an error
budget.  The port of the JAX package's ``core/dse/pareto.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import metrics, mrsd, ppgen, reduction
from .export import materialize
from .multiplier import MultiplierAssignment, search_assignments


@dataclasses.dataclass
class CandidatePoint:
    """One explored design: assignment + exported schedule + measured scores."""

    n_digits: int
    border: int | None
    candidate: int                    # rank within its (n_digits, border)
    assignment: MultiplierAssignment
    schedule: reduction.Schedule
    measured: dict[str, float]        # Table I metrics from the candidate batch
    energy: float                     # cost_fn(schedule)
    frontier: bool = False

    @property
    def err_abs_mred(self) -> float:
        return abs(self.measured["mred"])


def measure_candidates(
    schedules: Sequence[reduction.Schedule],
    *,
    n_samples: int,
    seed: int = 0,
    chunk: int = 16384,
    device: str | torch.device = "cuda",
) -> list[dict[str, float]]:
    """Table I metrics for each candidate, one shared operand chunk at a time.

    All schedules must share ``n_digits``.  The exact reference schedule is
    appended to the same candidate batch, so reference products come from
    the identical operand stream at no extra host cost.
    """
    from .. import engine as engine_mod

    n = schedules[0].n_digits
    exact = reduction.get_schedule(n, None)
    batch = engine_mod.compile_candidates([*schedules, exact], device)
    max_abs = (16.0 ** n * (16.0 / 15.0)) ** 2
    accs = [metrics.ErrorAccumulator(max_abs=max_abs) for _ in schedules]
    rng = np.random.default_rng(seed)
    remaining = n_samples
    while remaining > 0:
        b = min(chunk, remaining)
        xd = mrsd.random_digits(rng, n, b)
        yd = mrsd.random_digits(rng, n, b)
        xb = ppgen.flatten_operand_bits(xd)
        yb = ppgen.flatten_operand_bits(yd)
        outs = batch.evaluate_split(xb, yb)
        elo, ehi = outs[-1]
        for acc, (lo, hi) in zip(accs, outs[:-1]):
            acc.update_split(lo, hi, elo, ehi)
        remaining -= b
    return [acc.result() for acc in accs]


def measured_score_hook(
    *,
    key: str = "std_ed",
    n_samples: int = 20000,
    seed: int = 0,
    chunk: int = 16384,
    device: str | torch.device = "cuda",
) -> Callable[[Sequence[MultiplierAssignment]], list[float]]:
    """A ``search_assignments(score_hook=...)`` factory scoring candidates by
    a MEASURED Monte-Carlo metric (default ``std_ed``, the error-distance
    standard deviation) instead of the analytic |expected error| alone.

    The analytic bound tracks only the error MEAN; the engine loop already
    measures the full distribution, so re-ranking a wider analytic pool by
    measured variance costs one candidate batch and picks designs
    whose error is both small and tight (the ROADMAP's variance-aware
    scoring carry-over; the per-layer policy search consumes these).
    """

    def hook(assignments: Sequence[MultiplierAssignment]) -> list[float]:
        measured = measure_candidates(
            [materialize(a) for a in assignments],
            n_samples=n_samples, seed=seed, chunk=chunk, device=device)
        return [abs(float(m[key])) for m in measured]

    return hook


def pareto_front(errs: Sequence[float], costs: Sequence[float]) -> list[bool]:
    """Non-dominated flags under joint minimization of (error, cost).

    A point is dominated when another is <= on both axes and < on at least
    one; duplicate points are both kept on the frontier.
    """
    flags = []
    pts = list(zip(errs, costs))
    for i, (e, c) in enumerate(pts):
        dominated = any(
            (e2 <= e and c2 <= c and (e2 < e or c2 < c))
            for j, (e2, c2) in enumerate(pts) if j != i
        )
        flags.append(not dominated)
    return flags


def pareto_sweep(
    n_digits: int,
    borders: Sequence[int],
    *,
    k: int = 2,
    n_samples: int = 20000,
    seed: int = 0,
    chunk: int = 16384,
    cost_fn: Callable[[reduction.Schedule], float] | None = None,
    err_key: str = "mred",
    device: str | torch.device = "cuda",
    **search_kwargs,
) -> list[CandidatePoint]:
    """Full engine-in-the-loop sweep for one digit width.

    For every border: ``k`` best whole-multiplier assignments, materialized
    and measured together on ``device`` (one candidate batch per chunk
    covers every border's candidates), costed by ``cost_fn`` (default: the
    model-free ``energy.literal_energy_proxy``), and flagged with the
    per-digit-width (|measured err_key|, energy) Pareto frontier.
    """
    from .. import energy as energy_mod  # deferred: energy -> amrmul -> ... -> dse

    cost_fn = cost_fn or energy_mod.literal_energy_proxy
    points: list[CandidatePoint] = []
    for border in borders:
        assignments = search_assignments(n_digits, border, k=k, **search_kwargs)
        for rank, a in enumerate(assignments):
            sched = materialize(a)
            points.append(CandidatePoint(
                n_digits, border, rank, a, sched,
                measured={}, energy=float(cost_fn(sched))))
    measured = measure_candidates(
        [pt.schedule for pt in points],
        n_samples=n_samples, seed=seed, chunk=chunk, device=device)
    for pt, m in zip(points, measured):
        pt.measured = m
    flags = pareto_front(
        [abs(pt.measured[err_key]) for pt in points],
        [pt.energy for pt in points])
    for pt, f in zip(points, flags):
        pt.frontier = f
    return points


def select_border(
    n_digits: int,
    borders: Sequence[int],
    *,
    max_err: float,
    err_key: str = "mared",
    n_samples: int = 20000,
    seed: int = 0,
    cost_fn: Callable[[reduction.Schedule], float] | None = None,
    device: str | torch.device = "cuda",
    **sweep_kwargs,
) -> int:
    """Cheapest explored border whose measured error meets the budget.

    Runs ``pareto_sweep`` with ``k=1`` and returns the border of the
    lowest-energy point with ``|measured[err_key]| <= max_err`` (signed
    metrics like ``mred`` are compared by magnitude, matching the frontier
    axis); raises ``ValueError`` when no explored design meets the budget
    (widen the border sweep or relax ``max_err``).
    """
    points = pareto_sweep(
        n_digits, borders, k=1, n_samples=n_samples, seed=seed,
        cost_fn=cost_fn, err_key=err_key, device=device, **sweep_kwargs)
    ok = [pt for pt in points if abs(pt.measured[err_key]) <= max_err]
    if not ok:
        raise ValueError(
            f"no border in {list(borders)} meets |{err_key}| <= {max_err} "
            f"(best: {min(abs(pt.measured[err_key]) for pt in points):.3g})")
    return min(ok, key=lambda pt: (pt.energy, pt.border)).border
