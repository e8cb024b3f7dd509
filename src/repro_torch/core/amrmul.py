"""AMR-MUL: the approximate maximally-redundant signed-digit multiplier.

Facade over ppgen/reduction/dse: pulls the static schedule from the
process-level cache, then evaluates bit-accurately on one of two backends
and reports the paper's metrics, cell-usage breakdown (Fig. 5) and
cost-model hooks (Table II).  The port of the JAX package's
``core/amrmul.py``.

Backends (``engine=`` at construction or per call):
  * ``"torch"`` (the default) — the batched replay of ``core.engine`` on
    ``device`` (``"cuda"`` unless the caller names another; no CPU
    fallback), bit-exact against the numpy path and much faster at large
    batch,
  * ``"numpy"`` — host replay via ``reduction.evaluate_split``, the
    reference the torch engine is held against.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from . import metrics, mrsd, ppgen, reduction

ENGINES = ("numpy", "torch")


@dataclasses.dataclass(frozen=True)
class AMRMulConfig:
    n_digits: int
    border: int | None = None  # None = exact MRSD multiplier

    def tag(self) -> str:
        b = "exact" if self.border is None else f"b{self.border}"
        return f"amrmul_{self.n_digits}d_{b}"


class AMRMultiplier:
    """N x N-digit radix-16 MRSD multiplier with approximate border ``b``.

    ``device`` is where the ``"torch"`` engine replays, the card unless the
    caller passes ``device="cpu"``; the ``"numpy"`` engine runs on the host
    and never reads it.
    """

    def __init__(self, n_digits: int, border: int | None = None, engine: str = "torch",
                 device: str | torch.device = "cuda"):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.cfg = AMRMulConfig(n_digits, border)
        self.engine = engine
        self.device = device
        self.schedule = reduction.get_schedule(n_digits, border)

    # ------------------------------------------------------------------ eval
    def multiply_digits(
        self, x_digits: np.ndarray, y_digits: np.ndarray, engine: str | None = None
    ) -> np.ndarray:
        """(batch, N) digit arrays -> (batch,) float64 product values."""
        return reduction.split_to_float(
            *self.multiply_digits_split(x_digits, y_digits, engine=engine)
        )

    def multiply_digits_split(
        self, x_digits: np.ndarray, y_digits: np.ndarray, engine: str | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact split-integer products (lo, hi): value = lo + hi * 2**32."""
        backend = engine or self.engine
        xb = ppgen.flatten_operand_bits(x_digits)
        yb = ppgen.flatten_operand_bits(y_digits)
        if backend == "torch":
            from . import engine as engine_mod

            eng = engine_mod.get_engine(self.cfg.n_digits, self.cfg.border, self.device)
            return eng.evaluate_split(xb, yb)
        if backend != "numpy":
            raise ValueError(f"engine must be one of {ENGINES}, got {backend!r}")
        return reduction.evaluate_split(self.schedule, xb, yb)

    def multiply_values(self, x, y, engine: str | None = None) -> np.ndarray:
        """Integer values -> product values (canonical MRSD encoding)."""
        xd = mrsd.encode(np.asarray(x), self.cfg.n_digits)
        yd = mrsd.encode(np.asarray(y), self.cfg.n_digits)
        return self.multiply_digits(xd, yd, engine=engine)

    # ----------------------------------------------------------------- stats
    @property
    def n_stages(self) -> int:
        return self.schedule.n_stages

    @property
    def cell_counts(self) -> dict[str, int]:
        return dict(self.schedule.cell_counts)

    def cell_usage_percent(self) -> dict[str, float]:
        """Fig. 5-style breakdown over FA-class cells (HA excluded)."""
        fa = {k: v for k, v in self.schedule.cell_counts.items() if k != "HA"}
        total = sum(fa.values())
        return {k: 100.0 * v / total for k, v in sorted(fa.items())} if total else {}

    @property
    def expected_error(self) -> float:
        return float(self.schedule.expected_error)

    # ----------------------------------------------------------- monte carlo
    def monte_carlo(
        self,
        n_samples: int,
        seed: int = 0,
        chunk: int = 32768,
        exact_ref: "AMRMultiplier | None" = None,
        engine: str | None = None,
    ) -> dict[str, float]:
        """Paper §IV accuracy protocol: uniform random digit-vector inputs.

        Returns MRED/MARED/NMED (signed means as in Table I) plus aux stats.
        The default exact reference replays on this multiplier's device.
        """
        if exact_ref is None:
            exact_ref = _exact_cached(self.cfg.n_digits, self.device)
        return metrics.monte_carlo_metrics(
            self, exact_ref, n_samples,
            seed=seed, chunk=chunk, engine=engine or self.engine,
        )


@lru_cache(maxsize=8)
def _exact_cached(n_digits: int, device: str | torch.device = "cuda") -> AMRMultiplier:
    return AMRMultiplier(n_digits, border=None, device=device)


def exact_multiplier(n_digits: int, device: str | torch.device = "cuda") -> AMRMultiplier:
    return _exact_cached(n_digits, device)
