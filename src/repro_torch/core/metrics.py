"""Error metrics used in the paper's Table I.

  MRED  = mean( (approx - exact) / exact )          (signed; Table I shows
                                                     negative entries)
  MARED = mean( |approx - exact| / |exact| )
  NMED  = mean( approx - exact ) / max|product|      (signed, ditto)

plus auxiliary: nmed_abs (mean|ED|/max), error std/mean (Fig. 6 context).
Zero exact products are excluded from relative metrics (standard practice).
Streaming accumulator so 10^6-sample sweeps run in bounded memory.

A copy of the JAX package's ``core/metrics.py``: the float64 sums stay on
the host, chunk by chunk in order, so a metric has the JAX package's bits
whichever engine replayed the products.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import mrsd


@dataclasses.dataclass
class ErrorAccumulator:
    max_abs: float
    n: int = 0
    n_rel: int = 0
    sum_red: float = 0.0
    sum_ared: float = 0.0
    sum_ed: float = 0.0
    sum_aed: float = 0.0
    sum_ed2: float = 0.0

    def update_split(self, approx_lo, approx_hi, exact_lo, exact_hi) -> None:
        """Exact error distance from split-integer values (see reduction._SPLIT)."""
        ed = ((approx_hi - exact_hi) * (1 << 32) + (approx_lo - exact_lo)).astype(np.float64)
        exact = exact_hi.astype(np.float64) * float(1 << 32) + exact_lo.astype(np.float64)
        self._accumulate(ed, exact)

    def update(self, approx: np.ndarray, exact: np.ndarray) -> None:
        approx = np.asarray(approx, dtype=np.float64)
        exact = np.asarray(exact, dtype=np.float64)
        self._accumulate(approx - exact, exact)

    def _accumulate(self, ed: np.ndarray, exact: np.ndarray) -> None:
        nz = exact != 0
        re = ed[nz] / exact[nz]
        self.n += ed.size
        self.n_rel += int(nz.sum())
        self.sum_red += float(re.sum())
        self.sum_ared += float(np.abs(re).sum())
        self.sum_ed += float(ed.sum())
        self.sum_aed += float(np.abs(ed).sum())
        self.sum_ed2 += float((ed * ed).sum())

    def result(self) -> dict[str, float]:
        n = max(self.n, 1)
        nr = max(self.n_rel, 1)
        mean_ed = self.sum_ed / n
        return {
            "mred": self.sum_red / nr,
            "mared": self.sum_ared / nr,
            "nmed": mean_ed / self.max_abs,
            "nmed_abs": (self.sum_aed / n) / self.max_abs,
            "mean_ed": mean_ed,
            "std_ed": float(np.sqrt(max(self.sum_ed2 / n - mean_ed**2, 0.0))),
            "n_samples": float(self.n),
        }


def monte_carlo_metrics(
    approx_mul,
    exact_mul,
    n_samples: int,
    *,
    seed: int = 0,
    chunk: int = 32768,
    engine: str = "torch",
) -> dict[str, float]:
    """Streaming Monte-Carlo error metrics for one design point.

    ``approx_mul``/``exact_mul`` are AMRMultiplier-likes; ``engine`` selects
    the replay backend (the "torch" engine on each multiplier's device by
    default, or the "numpy" host replay) — both are bit-exact, so the
    metrics are backend-independent.
    """
    rng = np.random.default_rng(seed)
    n = approx_mul.cfg.n_digits
    max_abs = (16.0 ** n * (16.0 / 15.0)) ** 2  # |min value|^2 bound
    acc = ErrorAccumulator(max_abs=max_abs)
    remaining = n_samples
    while remaining > 0:
        b = min(chunk, remaining)
        xd = mrsd.random_digits(rng, n, b)
        yd = mrsd.random_digits(rng, n, b)
        alo, ahi = approx_mul.multiply_digits_split(xd, yd, engine=engine)
        elo, ehi = exact_mul.multiply_digits_split(xd, yd, engine=engine)
        acc.update_split(alo, ahi, elo, ehi)
        remaining -= b
    return acc.result()


def relative_errors(approx: np.ndarray, exact: np.ndarray) -> np.ndarray:
    """Per-sample relative error (Fig. 6 distribution), zeros excluded."""
    approx = np.asarray(approx, dtype=np.float64)
    exact = np.asarray(exact, dtype=np.float64)
    nz = exact != 0
    return (approx[nz] - exact[nz]) / exact[nz]
