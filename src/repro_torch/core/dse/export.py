"""Materialize DSE assignments into artifacts the rest of the system consumes.

The port of the JAX package's ``core/dse/export.py``.

``materialize`` turns a ``MultiplierAssignment`` (a decision record from the
whole-multiplier search) into a real ``reduction.Schedule`` by replaying the
recorded choices through ``reduction.build_schedule``'s pluggable assigner —
so the exported schedule has genuine wiring, feeds ``core.engine``'s
replay, metrics, and the energy model unchanged, and its bookkeeping is
asserted bit-identical to the search's (``expected_error`` must round-trip
exactly or the export raises).  ``materialize_choices`` rebuilds a schedule
from recorded decisions alone (``ColumnChoice``s, or anything with their
fields), as a recorded candidate such as ``chip_smoke.DSE_CANDIDATE`` is.

``lut_from_schedule`` closes the loop to the kernel path: for a 2-digit
schedule it produces the 256x256 int32 product table in the exact layout of
``lut.build_int8_lut``.  The JAX package evaluates it through its compiled
engine; the port through the numpy ``reduction.evaluate_split``, never
through the circuit replay of ``core/engine``, so the table that the inject
audit holds the replay to is independent of the replay.
"""
from __future__ import annotations

import numpy as np

from .. import reduction
from .multiplier import MultiplierAssignment


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
    """Recorded decisions -> a wired schedule; raises ``AssertionError``
    where they do not fit ``reduction.build_schedule``'s columns."""
    replayer = _ReplayAssigner(choices)
    sched = reduction.build_schedule(n_digits, border, assigner=replayer)
    replayer.finish()
    return sched


def materialize(assignment: MultiplierAssignment) -> reduction.Schedule:
    """Recorded assignment -> fully wired ``reduction.Schedule``.

    The returned schedule is NOT entered in the ``get_schedule`` cache (that
    cache is reserved for the default greedy policy); compile it with
    ``engine.compile_schedule`` / ``engine.compile_candidates`` for batched
    evaluation.  Raises ``AssertionError`` if the wired schedule's exact
    expected error disagrees with the search's — the count-level
    simulation and the wired schedule must agree bit for bit.
    """
    sched = materialize_choices(assignment.n_digits, assignment.border, assignment.choices)
    if sched.expected_error != assignment.expected_error:
        raise AssertionError(
            f"expected-error mismatch after export: search "
            f"{assignment.expected_error} vs schedule {sched.expected_error}")
    return sched


def lut_from_schedule(schedule: reduction.Schedule) -> np.ndarray:
    """(256, 256) int32 product table of a custom 2-digit schedule
    (index = value + 128), by the numpy replay over all 2^16 int8 pairs."""
    if schedule.n_digits != 2:
        raise ValueError("int8 LUT export requires a 2-digit schedule")
    from .. import lut  # deferred: lut -> amrmul -> reduction -> dse

    return lut.schedule_table(schedule)
