"""Analytical delay/power/energy/area model for (A)MR-MUL designs.

The paper synthesizes with Synopsys DC on NanGate 45nm (Table II); no
synthesis flow exists here, so we use a *linear component model*

    area   = a_pp * n_pp_gates + sum_cells a_cell(type) + a_dig * n_result_digits
    energy = e_pp * n_pp_gates + sum_cells e_cell(type) + e_dig * n_result_digits
    delay  = d0 + d_fa * n_stages_exact + d_fa_approx * n_stages_border_crossed

with per-cell coefficients proportional to each cell's minimal-SOP literal
count (cells.logic_complexity) times technology scale factors. The scale
factors are **calibrated by least squares against the paper's own Table II**
(18 design points: 3 widths x {exact + 5 borders}) — the calibration fit and
its residuals are a reported benchmark artifact (benchmarks/table2_energy.py),
not hidden constants.  A copy of the JAX package's ``core/energy.py``.

Rationale for the structure (DESIGN.md §2): a synthesized design's
power/area track switched capacitance ~ literal count; approximate cells are
strictly simpler (enforced in cells.py); PP gates are single gates; the
final BSD->MRSD conversion is XORs + 4-bit adders, linear in result digits.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .amrmul import AMRMultiplier
from .cells import CELLS, logic_complexity


def _cell_literals(name: str) -> int:
    c = CELLS[name]
    sk = sum(int(b) << i for i, b in enumerate(c.sum_table))
    ck = sum(int(b) << i for i, b in enumerate(c.carry_table))
    base = logic_complexity(sk) + logic_complexity(ck)
    # constants/pass-throughs still cost wiring/buffering: floor of 1 literal
    return max(base, 1)


CELL_LITERALS = {name: _cell_literals(name) for name in CELLS}


@dataclasses.dataclass(frozen=True)
class DesignFeatures:
    """Structural features of one multiplier design (model inputs)."""

    n_digits: int
    border: int | None
    n_pp_gates: int
    exact_cell_literals: int
    approx_cell_literals: int
    n_result_digits: int
    n_stages: int
    approx_cell_frac: float  # fraction of FA-class cells that are approximate

    @classmethod
    def from_schedule(cls, schedule) -> "DesignFeatures":
        """Features straight from a ``reduction.Schedule`` — works for both
        cached design points and ad-hoc DSE-exported candidate schedules
        (which never pass through an ``AMRMultiplier``)."""
        counts = schedule.cell_counts
        exact_lit = sum(CELL_LITERALS[k] * v for k, v in counts.items()
                        if not CELLS[k].approx)
        approx_lit = sum(CELL_LITERALS[k] * v for k, v in counts.items()
                         if CELLS[k].approx)
        fa_total = sum(v for k, v in counts.items() if k != "HA")
        fa_approx = sum(v for k, v in counts.items() if CELLS[k].approx)
        return cls(
            n_digits=schedule.n_digits,
            border=schedule.border,
            n_pp_gates=schedule.layout.n_pp,
            exact_cell_literals=exact_lit,
            approx_cell_literals=approx_lit,
            n_result_digits=2 * schedule.n_digits + 1,
            n_stages=schedule.n_stages,
            approx_cell_frac=(fa_approx / fa_total) if fa_total else 0.0,
        )

    @classmethod
    def from_multiplier(cls, m: AMRMultiplier) -> "DesignFeatures":
        return cls.from_schedule(m.schedule)

    def basis(self) -> np.ndarray:
        """Feature vector for the linear area/energy model."""
        return np.array(
            [self.n_pp_gates, self.exact_cell_literals, self.approx_cell_literals,
             self.n_result_digits],
            dtype=np.float64,
        )


@dataclasses.dataclass
class CostModel:
    """Calibrated linear model; produced by ``fit`` (see table2 benchmark)."""

    area_coef: np.ndarray    # per basis()
    energy_coef: np.ndarray
    delay_d0: float
    delay_per_stage: float
    delay_approx_scale: float  # stage delay multiplier as approx_frac -> 1

    def area(self, f: DesignFeatures) -> float:
        return float(f.basis() @ self.area_coef)

    def energy(self, f: DesignFeatures) -> float:
        return float(f.basis() @ self.energy_coef)

    def delay(self, f: DesignFeatures) -> float:
        scale = 1.0 - self.delay_approx_scale * f.approx_cell_frac
        return self.delay_d0 + self.delay_per_stage * f.n_stages * scale

    def power(self, f: DesignFeatures) -> float:
        """mW from pJ/op at max frequency (1/delay), as the paper reports."""
        return self.energy(f) / self.delay(f)


def fit(features: list[DesignFeatures],
        area: np.ndarray, energy: np.ndarray, delay: np.ndarray) -> CostModel:
    """Non-negative least squares (projected) calibration to reference data."""
    X = np.stack([f.basis() for f in features])

    def nnls(X, y):
        # simple projected-gradient NNLS (small problems; avoids scipy dep)
        w = np.maximum(np.linalg.lstsq(X, y, rcond=None)[0], 0.0)
        lr = 1.0 / (np.linalg.norm(X, 2) ** 2 + 1e-9)
        for _ in range(5000):
            w = np.maximum(w - lr * (X.T @ (X @ w - y)), 0.0)
        return w

    area_coef = nnls(X, np.asarray(area, dtype=np.float64))
    energy_coef = nnls(X, np.asarray(energy, dtype=np.float64))

    # delay: d = d0 + d_s * stages * (1 - alpha * approx_frac); grid-search alpha
    stages = np.array([f.n_stages for f in features], dtype=np.float64)
    fr = np.array([f.approx_cell_frac for f in features], dtype=np.float64)
    dly = np.asarray(delay, dtype=np.float64)
    best = None
    for alpha in np.linspace(0.0, 0.6, 121):
        A = np.stack([np.ones_like(stages), stages * (1 - alpha * fr)], axis=1)
        coef, *_ = np.linalg.lstsq(A, dly, rcond=None)
        resid = float(((A @ coef - dly) ** 2).sum())
        if best is None or resid < best[0]:
            best = (resid, float(coef[0]), float(coef[1]), float(alpha))
    _, d0, ds, alpha = best
    return CostModel(area_coef, energy_coef, d0, ds, alpha)


def literal_energy_proxy(schedule) -> float:
    """Model-free energy surrogate: unit-weight switched-literal count.

    ``basis() @ 1`` — PP gates + cell SOP literals + result digits — tracks
    switched capacitance without any calibration data, so the DSE Pareto
    sweep has a deterministic default cost axis.  Pass a calibrated
    ``CostModel.energy`` instead (``benchmarks.dse_bench`` does) for pJ
    predictions comparable to the paper's Table II.
    """
    return float(DesignFeatures.from_schedule(schedule).basis().sum())


def predict(model: CostModel, m: AMRMultiplier) -> dict[str, float]:
    f = DesignFeatures.from_multiplier(m)
    return {
        "area_um2": model.area(f),
        "energy_pj": model.energy(f),
        "delay_ns": model.delay(f),
        "power_mw": model.power(f),
    }
