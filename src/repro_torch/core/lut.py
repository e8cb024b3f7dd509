"""int8 product tables and low-rank error factors, and their device tensors.

``build_int8_lut`` evaluates the bit-accurate 2-digit AMR-MUL over all
2^8 x 2^8 signed int8 pairs once with the numpy schedule replay; the
resulting 256x256 int32 table *is* the paper's arithmetic for 8-bit
operands (the 2-digit MRSD range [-272, 255] strictly contains int8).  It
is the same computation as the JAX package's ``build_int8_lut(border,
engine="numpy")``, and the parity tests hold the two bit for bit.

``lowrank_factor`` SVD-factors the error table E(a, b) = AMR(a, b) - a*b
into rank-r terms E ~= U[a] . V[b] with the same numpy SVD as the JAX
package.  Every entry of the residual obeys
``|E(a,b) - (U V^T)(a,b)| <= sigma_{r+1}`` (``LowRankFactors.sigma_next``),
so a K-term dot product carries at most ``K * sigma_{r+1}`` extra error.

``table_tensor`` / ``factor_tensors`` are the per-device cached tensors
the kernels and the numerics read; no call site converts a table itself.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from . import mrsd, ppgen, reduction

_N_DIGITS = 2      # int8 operands need exactly 2 radix-16 MRSD digits


def _int8_value_grid() -> tuple[np.ndarray, np.ndarray]:
    """All 2^16 int8 pairs in row-major table order: (a repeated, b tiled)."""
    vals = np.arange(-128, 128, dtype=np.int64)
    return np.repeat(vals, 256), np.tile(vals, 256)


def _int8_operand_bits() -> tuple[np.ndarray, np.ndarray]:
    """Stored operand bits of all 2^16 int8 pairs, in table order."""
    a, b = _int8_value_grid()
    xb = ppgen.flatten_operand_bits(mrsd.encode(a, _N_DIGITS))
    yb = ppgen.flatten_operand_bits(mrsd.encode(b, _N_DIGITS))
    return xb, yb


def schedule_table(schedule: reduction.Schedule) -> np.ndarray:
    """(256, 256) int32 products of a 2-digit schedule, by the numpy replay
    (``reduction.evaluate_split``) over every int8 pair."""
    prod = reduction.split_to_float(*reduction.evaluate_split(schedule, *_int8_operand_bits()))
    return prod.astype(np.int32).reshape(256, 256)  # exact: 2-digit products < 2**19


@lru_cache(maxsize=None)
def build_int8_lut(border: int | None) -> np.ndarray:
    """(256, 256) int32: LUT[a+128, b+128] = AMR-MUL_2digit(a, b).

    Cached per border; callers must not mutate the returned array.
    """
    table = schedule_table(reduction.get_schedule(_N_DIGITS, border))
    table.flags.writeable = False
    return table


def exact_int8_table() -> np.ndarray:
    a, b = _int8_value_grid()
    return (a * b).astype(np.int32).reshape(256, 256)


@dataclasses.dataclass(frozen=True)
class LowRankFactors:
    """E(a, b) ~= U[a+128] @ V[b+128].T, shapes (256, r)."""

    border: int | None
    rank: int
    u: np.ndarray        # (256, r) float32
    v: np.ndarray        # (256, r) float32
    residual_fro: float  # ||E - UV'||_F / ||E||_F (0 when rank covers spectrum)
    sigma_next: float    # sigma_{r+1}: bound on every entry of E - UV'


@lru_cache(maxsize=64)
def lowrank_factor(border: int | None, rank: int) -> LowRankFactors:
    err = build_int8_lut(border).astype(np.float64) - exact_int8_table().astype(np.float64)
    U, s, Vt = np.linalg.svd(err, full_matrices=False)
    r = min(rank, 256)
    sr = np.sqrt(s[:r])
    u = (U[:, :r] * sr).astype(np.float32)
    v = (Vt[:r, :].T * sr).astype(np.float32)
    denom = float(np.linalg.norm(err)) or 1.0
    resid = float(np.linalg.norm(err - (u.astype(np.float64) @ v.T.astype(np.float64)))) / denom
    sigma_next = float(s[r]) if r < s.shape[0] else 0.0
    return LowRankFactors(border, r, u, v, resid, sigma_next)


@lru_cache(maxsize=64)
def table_max_abs(border: int | None) -> int:
    """Exact max |product| of the design point (int32-saturation guards)."""
    return int(np.abs(build_int8_lut(border)).max())


def error_stats(border: int | None) -> dict[str, float]:
    """Summary statistics of the int8 error table."""
    lut = build_int8_lut(border).astype(np.float64)
    err = lut - exact_int8_table().astype(np.float64)
    return {
        "mean": float(err.mean()),
        "std": float(err.std()),
        "max_abs": float(np.abs(err).max()),
        "rel_std": float((err / np.maximum(np.abs(exact_int8_table()), 1)).std()),
    }


@lru_cache(maxsize=64)
def table_tensor(border: int | None, device: torch.device) -> torch.Tensor:
    """Cached (256, 256) int32 product table on ``device``."""
    return torch.from_numpy(build_int8_lut(border).copy()).to(device)


@lru_cache(maxsize=64)
def factor_tensors(border: int | None, rank: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Cached (u, v) float32 factors, each (256, r), on ``device``."""
    f = lowrank_factor(border, rank)
    return (torch.from_numpy(np.ascontiguousarray(f.u)).to(device),
            torch.from_numpy(np.ascontiguousarray(f.v)).to(device))
