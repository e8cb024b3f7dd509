"""int8 product tables and low-rank error factors, and their device tensors.

``build_int8_luts`` evaluates the bit-accurate 2-digit AMR-MUL over all
2^8 x 2^8 signed int8 pairs; the resulting 256x256 int32 table *is* the
paper's arithmetic for 8-bit operands (the 2-digit MRSD range [-272, 255]
strictly contains int8).  Two backends, as in the JAX package's
``core/lut.py``:

* ``engine="torch"`` (the default): every missing border from ONE packed
  operand batch of all 2^16 pairs through ``engine.evaluate_split_many``
  on ``device`` (``"cuda"`` unless the caller names another);
* ``engine="numpy"``: one host replay a border
  (``reduction.evaluate_split``, ``schedule_table``).

Tables are cached per ``(border, engine, device)`` with provenance
(``Int8LUT``, ``lut_record``).  The tables the kernels and the numerics
read (``table_tensor``, ``factor_tensors``, ``lowrank_factor``,
``table_max_abs``, ``error_stats``) are pinned to the numpy replay: a
table that a kernel or the inject audit is held against never comes from
the circuit replay under test.  The parity
tests hold both backends bit for bit to the JAX package's tables.

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

from ..device import resolve_device
from . import mrsd, ppgen, reduction

INT8_OFFSET = 128  # index = value + 128
_N_DIGITS = 2      # int8 operands need exactly 2 radix-16 MRSD digits


@dataclasses.dataclass(frozen=True)
class Int8LUT:
    """A cached product table plus the provenance of the backend that built it."""

    n_digits: int
    border: int | None
    engine: str                # "torch" (engine replay) | "numpy" (host reference)
    device: torch.device | None  # where the torch engine ran; None for numpy
    table: np.ndarray          # (256, 256) int32, LUT[a+128, b+128] = AMR(a, b)


_LUT_CACHE: dict[tuple, Int8LUT] = {}


def _int8_value_grid() -> tuple[np.ndarray, np.ndarray]:
    """All 2^16 int8 pairs in row-major table order: (a repeated, b tiled)."""
    vals = np.arange(-128, 128, dtype=np.int64)
    return np.repeat(vals, 256), np.tile(vals, 256)


@lru_cache(maxsize=1)
def _int8_operand_bits() -> tuple[np.ndarray, np.ndarray]:
    """Stored operand bits of all 2^16 int8 pairs, in table order: encoded
    and flattened once (MRSD encoding is border-independent)."""
    a, b = _int8_value_grid()
    xb = ppgen.flatten_operand_bits(mrsd.encode(a, _N_DIGITS))
    yb = ppgen.flatten_operand_bits(mrsd.encode(b, _N_DIGITS))
    return xb, yb


def _split_table(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    prod = reduction.split_to_float(lo, hi)  # exact: 2-digit products < 2**19
    return prod.astype(np.int32).reshape(256, 256)


def _cache(border: int | None, engine: str, device: torch.device | None,
           table: np.ndarray) -> None:
    table.flags.writeable = False  # shared by every caller: nobody mutates it
    _LUT_CACHE[(_N_DIGITS, border, engine, device)] = Int8LUT(
        _N_DIGITS, border, engine, device, table)


def schedule_table(schedule: reduction.Schedule) -> np.ndarray:
    """(256, 256) int32 products of a 2-digit schedule, by the numpy replay
    (``reduction.evaluate_split``) over every int8 pair."""
    return _split_table(*reduction.evaluate_split(schedule, *_int8_operand_bits()))


def build_int8_luts(
    borders: tuple[int | None, ...], engine: str = "torch",
    device: str | torch.device = "cuda",
) -> dict[int | None, np.ndarray]:
    """Batched multi-border build: ``{border: (256, 256) int32 table}``.

    With ``engine="torch"`` every border missing from the process-level
    cache comes from ONE engine call on ``device`` over a shared bit-packed
    operand batch; ``engine="numpy"`` replays each border on the host (the
    reference the torch tables are held bit-exact against).  Callers must
    not mutate the returned arrays.
    """
    from .amrmul import ENGINES  # deferred: amrmul -> reduction -> dse -> export -> lut

    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    dev = resolve_device(device) if engine == "torch" else None
    borders = tuple(borders)
    missing = tuple(dict.fromkeys(
        b for b in borders if (_N_DIGITS, b, engine, dev) not in _LUT_CACHE))
    if missing and engine == "torch":
        from . import engine as engine_mod

        splits = engine_mod.evaluate_split_many(_N_DIGITS, missing, *_int8_operand_bits(), dev)
        for b, (lo, hi) in splits.items():
            _cache(b, engine, dev, _split_table(lo, hi))
    elif missing:
        for b in missing:
            _cache(b, engine, dev, schedule_table(reduction.get_schedule(_N_DIGITS, b)))
    return {b: _LUT_CACHE[(_N_DIGITS, b, engine, dev)].table for b in borders}


def build_int8_lut(border: int | None, engine: str = "torch",
                   device: str | torch.device = "cuda") -> np.ndarray:
    """(256, 256) int32: LUT[a+128, b+128] = AMR-MUL_2digit(a, b).

    Single-border convenience over ``build_int8_luts``: the same cache, the
    same backends.  Callers must not mutate the returned array.
    """
    return build_int8_luts((border,), engine, device)[border]


def lut_record(border: int | None, engine: str = "torch",
               device: str | torch.device = "cuda") -> Int8LUT:
    """The cached table WITH provenance (which backend, on which device)."""
    build_int8_luts((border,), engine, device)
    dev = resolve_device(device) if engine == "torch" else None
    return _LUT_CACHE[(_N_DIGITS, border, engine, dev)]


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
    err = (build_int8_lut(border, engine="numpy").astype(np.float64)
           - exact_int8_table().astype(np.float64))
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
    return int(np.abs(build_int8_lut(border, engine="numpy")).max())


def error_stats(border: int | None) -> dict[str, float]:
    """Summary statistics of the int8 error table."""
    lut = build_int8_lut(border, engine="numpy").astype(np.float64)
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
    return torch.from_numpy(build_int8_lut(border, engine="numpy").copy()).to(device)


@lru_cache(maxsize=64)
def factor_tensors(border: int | None, rank: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Cached (u, v) float32 factors, each (256, r), on ``device``."""
    f = lowrank_factor(border, rank)
    return (torch.from_numpy(np.ascontiguousarray(f.u)).to(device),
            torch.from_numpy(np.ascontiguousarray(f.v)).to(device))
