"""AMR-MUL core: the paper's contribution as a composable library, ported
from the JAX package's ``core/`` (its public names).

  L0 bit-accurate MRSD multiplier model — mrsd / cells / ppgen / reduction /
     dse / amrmul / metrics / energy / baselines (numpy, copies of the JAX
     package's modules; the port never imports the JAX package)
  L0' batched bit-sliced replay in torch on a device (bit-exact vs L0) —
     engine
  L1 int8 LUT semantics + low-rank factorization, and the per-device
     tensors the kernels read — lut
(L2, the matmul numerics policy, lives in repro_torch.numerics; the CUDA
kernels in repro_torch.kernels.)  The parity tests hold every module bit
for bit against the JAX package's.
"""
from .amrmul import AMRMulConfig, AMRMultiplier, exact_multiplier
from .cells import CELLS, PAPER_AVG_ERR
from .dse import (MultiplierAssignment, assign_column, materialize,
                  pareto_sweep, search_assignments, select_border)
from .lut import (Int8LUT, build_int8_lut, build_int8_luts, error_stats,
                  exact_int8_table, lowrank_factor, lut_record)
from .metrics import ErrorAccumulator, monte_carlo_metrics, relative_errors

__all__ = [
    "AMRMulConfig", "AMRMultiplier", "exact_multiplier",
    "CELLS", "PAPER_AVG_ERR", "assign_column",
    "MultiplierAssignment", "search_assignments", "materialize",
    "pareto_sweep", "select_border",
    "Int8LUT", "build_int8_lut", "build_int8_luts", "lut_record",
    "exact_int8_table", "lowrank_factor", "error_stats",
    "ErrorAccumulator", "monte_carlo_metrics", "relative_errors",
]
