"""Registered DSE candidates as artifacts the numerics consume.

The port of the part of the JAX package's ``core/dse/export.py`` that the
inject audit needs:

* ``ColumnChoice`` and ``materialize_choices``: a whole-multiplier
  assignment's recorded decisions (the cells of each approximate or border
  column with at least one FA, in the schedule builder's order) replayed
  through ``reduction.build_schedule``'s assigner into a wired
  ``reduction.Schedule``, as JAX's ``materialize`` does with a
  ``MultiplierAssignment`` (the search that makes one is not ported);
* ``lut_from_schedule``: the (256, 256) int32 product table of a 2-digit
  schedule in ``lut.build_int8_lut``'s layout.  The JAX package evaluates
  it through its compiled engine; the port through the numpy
  ``reduction.evaluate_split``, never through the circuit replay of
  ``core/engine``, so the table is independent of what the audit checks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import lut, reduction

__all__ = ["ColumnChoice", "materialize_choices", "lut_from_schedule"]


class ColumnChoice(NamedTuple):
    """Recorded decision: the cells assigned to one column of one stage."""

    stage: int
    p: int
    pos_cnt: int
    neg_cnt: int
    cells: tuple[tuple[str, int, int], ...]


class _ReplayAssigner:
    """Replays recorded choices in schedule-builder order, with validation."""

    def __init__(self, choices):
        self._queue = list(choices)
        self._idx = 0

    def __call__(self, p, pos_cnt, neg_cnt, _err_scaled, _allow_exact_fa):
        if (pos_cnt + neg_cnt) // 3 == 0:
            return []  # no FA consumed: HA/pass remainder, never recorded
        if self._idx >= len(self._queue):
            raise AssertionError("assignment has fewer decisions than the schedule")
        ch = self._queue[self._idx]
        self._idx += 1
        if (ch.p, ch.pos_cnt, ch.neg_cnt) != (p, pos_cnt, neg_cnt):
            raise AssertionError(
                f"assignment desync at decision {self._idx - 1}: recorded "
                f"(p={ch.p}, {ch.pos_cnt}+{ch.neg_cnt}) vs builder "
                f"(p={p}, {pos_cnt}+{neg_cnt})")
        return list(ch.cells)

    def finish(self) -> None:
        if self._idx != len(self._queue):
            raise AssertionError(
                f"{len(self._queue) - self._idx} recorded decisions unconsumed")


def materialize_choices(n_digits: int, border: int | None, choices) -> reduction.Schedule:
    """Recorded decisions (``ColumnChoice``s, or anything with their fields)
    -> a wired schedule; raises where they do not fit the builder's columns."""
    replayer = _ReplayAssigner(choices)
    sched = reduction.build_schedule(n_digits, border, assigner=replayer)
    replayer.finish()
    return sched


def lut_from_schedule(schedule: reduction.Schedule) -> np.ndarray:
    """(256, 256) int32 product table of a custom 2-digit schedule
    (index = value + 128), by the numpy replay over all 2^16 int8 pairs."""
    if schedule.n_digits != 2:
        raise ValueError("int8 LUT export requires a 2-digit schedule")
    return lut.schedule_table(schedule)
