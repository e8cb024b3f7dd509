"""Design-space exploration: the per-column cell assignment the reduction
schedule needs (the paper's Fig. 3 branch-and-bound), and a recorded
candidate's schedule and product table (``export``)."""
from .column import DSEResult, assign_column
from .export import ColumnChoice, lut_from_schedule, materialize_choices

__all__ = ["DSEResult", "assign_column", "ColumnChoice", "materialize_choices",
           "lut_from_schedule"]
