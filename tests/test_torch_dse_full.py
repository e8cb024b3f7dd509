"""The port's design-space exploration (``repro_torch.core.dse``) against
the JAX package's, on the CPU.

Column solvers and the whole-multiplier search are pure Python over
``Fraction``s, so their results are compared exactly: ``brute_force_column``,
``column_profile``, ``assign_column`` and ``assign_column_topk`` over a grid
of small columns; ``initial_columns``, ``compile_shape`` and
``greedy_assignment``; ``search_assignments``' choices, errors, node counts
and completeness at (2, 8) and in one small 4-digit search.  ``materialize``
round-trips (the schedule equal to the JAX package's export, its product
table too) and rejects a desynchronised or mislabelled assignment.  The
measured half runs the torch engine on the CPU: ``measure_candidates`` at 2
digits, ``pareto_sweep`` and ``select_border`` equal the JAX package's (its
jitted engine at 2 digits) bit for bit; ``pareto_front`` on random points.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

from repro.core import dse as jdse
from repro.core import reduction as jreduction
from repro.core.dse import column as jcolumn
from repro_torch.core import dse, reduction
from repro_torch.core.dse import column

from _torch_threads import one_intra_op_thread  # noqa: F401

CPU = "cpu"
SEARCH = dict(beam_width=8, branch_cap=4, max_nodes=2000)
ERRS = [Fraction(e, 4) for e in range(-3, 4)]


def _choices(a):
    return [dataclasses.astuple(c) for c in a.choices]


def _assignment(a):
    return (a.n_digits, a.border, _choices(a), a.expected_error, a.nodes, a.complete, a.tag())


def _schedule(s):
    return (s.n_digits, s.border, s.n_bits, s.n_stages, dict(s.cell_counts),
            s.expected_error, s.final_ids.tolist(), s.final_positions.tolist(),
            s.bit_polarity.tolist())


# ------------------------------------------------------------ column solvers
@pytest.mark.parametrize("exact_fa", [False, True])
@pytest.mark.parametrize("pos", range(6))
def test_column_solvers_equal_jax(pos, exact_fa):
    for neg in range(6):
        prof = column.column_profile(pos, neg, exact_fa)
        assert prof == jcolumn.column_profile(pos, neg, exact_fa)
        for err in ERRS:
            want = jcolumn.brute_force_column(pos, neg, err, allow_exact_fa=exact_fa)
            assert column.brute_force_column(pos, neg, err, allow_exact_fa=exact_fa) == want
            got = column.assign_column(pos, neg, err, allow_exact_fa=exact_fa)
            assert vars(got) == vars(jcolumn.assign_column(pos, neg, err, allow_exact_fa=exact_fa))
            assert abs(got.err) == want  # the branch and bound is optimal
            top = column.assign_column_topk(pos, neg, err, k=3, allow_exact_fa=exact_fa)
            assert [vars(r) for r in top] == [vars(r) for r in jcolumn.assign_column_topk(
                pos, neg, err, k=3, allow_exact_fa=exact_fa)]
            assert abs(top[0].err) == want


# ------------------------------------------------------------ the whole multiplier
@pytest.mark.parametrize("n_digits,border", [(2, 8), (2, None), (4, 12), (4, 16)])
def test_shape_and_greedy_equal_jax(n_digits, border):
    assert dse.initial_columns(n_digits) == jdse.initial_columns(n_digits)
    assert ([dataclasses.astuple(e) for e in dse.compile_shape(n_digits, border)]
            == [dataclasses.astuple(e) for e in jdse.compile_shape(n_digits, border)])
    greedy = dse.greedy_assignment(n_digits, border)
    assert _assignment(greedy) == _assignment(jdse.greedy_assignment(n_digits, border))
    # the greedy composition is reduction.build_schedule's own policy
    assert _schedule(dse.materialize(greedy)) == _schedule(reduction.get_schedule(n_digits, border))


@pytest.mark.parametrize("n_digits,border,k", [(2, 8, 1), (2, 8, 3), (4, 12, 2)])
def test_search_assignments_equal_jax(n_digits, border, k):
    got = dse.search_assignments(n_digits, border, k=k, **SEARCH)
    want = jdse.search_assignments(n_digits, border, k=k, **SEARCH)
    assert [_assignment(a) for a in got] == [_assignment(a) for a in want]
    assert len(got) == k and got[0].choices
    assert (abs(got[0].expected_error)
            <= abs(dse.greedy_assignment(n_digits, border).expected_error))
    for a in got:
        assert a.choices == tuple(dse.ColumnChoice(*dataclasses.astuple(c)) for c in a.choices)


def test_exact_design_has_no_decisions():
    [a] = dse.search_assignments(2, None)
    assert (a.choices, a.expected_error, a.complete) == ((), 0, True)


def test_materialize_round_trip_equals_jax():
    [t] = dse.search_assignments(2, 8, k=1, **SEARCH)
    [j] = jdse.search_assignments(2, 8, k=1, **SEARCH)
    ts, js = dse.materialize(t), jdse.materialize(j)
    assert _schedule(ts) == _schedule(js) and ts.expected_error == t.expected_error
    assert _schedule(dse.materialize_choices(2, 8, t.choices)) == _schedule(ts)
    np.testing.assert_array_equal(dse.lut_from_schedule(ts), jdse.lut_from_schedule(js))
    with pytest.raises(AssertionError, match="desync"):
        dse.materialize(dataclasses.replace(t, choices=t.choices[1:]))
    with pytest.raises(AssertionError, match="unconsumed"):
        dse.materialize(dataclasses.replace(t, choices=t.choices + t.choices[-1:]))
    with pytest.raises(AssertionError, match="expected-error mismatch"):
        dse.materialize(dataclasses.replace(t, expected_error=t.expected_error + 1))


# ------------------------------------------------------------ measured
def test_pareto_front_equals_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        errs = rng.integers(0, 6, 9).astype(float).tolist()
        costs = rng.integers(0, 6, 9).astype(float).tolist()
        assert dse.pareto_front(errs, costs) == jdse.pareto_front(errs, costs)
    assert dse.pareto_front([1.0, 1.0, 2.0], [1.0, 1.0, 0.5]) == [True, True, True]


def test_measure_candidates_equal_jax():
    ts = [dse.materialize(a) for a in dse.search_assignments(2, 8, k=2, **SEARCH)]
    ts += [reduction.get_schedule(2, 6)]
    js = [jdse.materialize(a) for a in jdse.search_assignments(2, 8, k=2, **SEARCH)]
    js += [jreduction.get_schedule(2, 6)]
    got = dse.measure_candidates(ts, n_samples=4000, seed=2, chunk=1024, device=CPU)
    assert got == jdse.measure_candidates(js, n_samples=4000, seed=2, chunk=1024)
    assert len({m["mared"] for m in got}) > 1


def test_pareto_sweep_and_select_border_equal_jax():
    kw = dict(n_samples=2048, chunk=1024, **SEARCH)
    got = dse.pareto_sweep(2, (6, 8), k=2, device=CPU, **kw)
    want = jdse.pareto_sweep(2, (6, 8), k=2, **kw)
    assert ([(p.border, p.candidate, _assignment(p.assignment), p.measured, p.energy,
              p.frontier, p.err_abs_mred) for p in got]
            == [(p.border, p.candidate, _assignment(p.assignment), p.measured, p.energy,
                 p.frontier, p.err_abs_mred) for p in want])
    assert any(p.frontier for p in got)
    assert (dse.select_border(2, (6, 7, 8), max_err=0.05, device=CPU, **kw)
            == jdse.select_border(2, (6, 7, 8), max_err=0.05, **kw))
    with pytest.raises(ValueError, match="meets"):
        dse.select_border(2, (8,), max_err=1e-9, device=CPU, **kw)
