"""Design-space exploration (paper §III.B / Fig. 3, grown up): the port of
the JAX package's ``core/dse`` package, ``model_policy`` aside.

  * ``column``     — the paper's per-column Fig. 3 branch-and-bound
    (``assign_column``), the exponential oracle (``brute_force_column``),
    and the exact achievable-error dynamic program (``column_profile`` /
    ``assign_column_topk``) that scales the oracle to tall columns.
  * ``multiplier`` — whole-multiplier search: the choice-independent
    reduction shape (``compile_shape``), greedy Fig. 3 composition
    (``greedy_assignment``, parity-anchored to ``reduction.build_schedule``)
    and the joint beam + branch-and-bound (``search_assignments``).
  * ``export``     — ``materialize`` an assignment (or recorded decisions,
    ``materialize_choices``) into a fully wired ``reduction.Schedule``
    (round-trip asserted) and ``lut_from_schedule`` into the kernel path's
    256x256 int8 product table.
  * ``pareto``     — measured Monte-Carlo scoring through the torch engine
    on a device, one shared operand chunk at a time
    (``measure_candidates``), (error, energy) frontier (``pareto_front`` /
    ``pareto_sweep``) and border selection under an error budget
    (``select_border``).
"""
from .column import (DSEResult, assign_column, assign_column_topk,
                     brute_force_column, column_profile)
from .export import lut_from_schedule, materialize, materialize_choices
from .multiplier import (ColumnChoice, MultiplierAssignment, ShapeEvent,
                         compile_shape, greedy_assignment, initial_columns,
                         search_assignments)
from .pareto import (CandidatePoint, measure_candidates, measured_score_hook,
                     pareto_front, pareto_sweep, select_border)

__all__ = [
    "DSEResult", "assign_column", "assign_column_topk", "brute_force_column",
    "column_profile",
    "ShapeEvent", "ColumnChoice", "MultiplierAssignment", "compile_shape",
    "initial_columns", "greedy_assignment", "search_assignments",
    "materialize", "materialize_choices", "lut_from_schedule",
    "CandidatePoint", "measure_candidates", "measured_score_hook",
    "pareto_front", "pareto_sweep", "select_border",
]
