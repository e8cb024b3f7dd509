"""Design-space exploration: the per-column cell assignment the reduction
schedule needs (the paper's Fig. 3 branch-and-bound)."""
from .column import DSEResult, assign_column

__all__ = ["DSEResult", "assign_column"]
