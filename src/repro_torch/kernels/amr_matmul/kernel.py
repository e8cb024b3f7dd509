"""Wrappers of the hand-written AMR matmul kernels (CUDA C++, ``csrc/``).

Three kernels, each replacing one Pallas kernel of the JAX package's
``kernels/amr_matmul/kernel.py``:

* ``amr_matmul_int8_lut``         -> ``_amr_matmul_lut_kernel``: full-table
  gather, int8 (M, K) @ (K, N) -> int32, bit-exact;
* ``amr_matmul_int8_lut_grouped`` -> ``_amr_matmul_lut_grouped_kernel``:
  the same gather per group, (G, M, K) @ (G, K, N) -> int32;
* ``amr_matmul_int8``             -> ``_amr_matmul_kernel``: low-rank form,
  int8 operands and float32 factors u, v (256, r) -> float32.

A tensor's device decides the route: CPU tensors go to the plain versions
in ``ref.py``; CUDA tensors go to the kernel, which raises on what it does
not take.  Each wrapper checks device, dtype, shape and contiguity,
allocates its outputs (zero-filled for the gather kernels, whose split-K
partial sums meet in atomics), launches on PyTorch's current stream and
counts the launch on its ``CudaKernel`` (``LUT``, ``LUT_GROUPED``,
``LOWRANK``).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path

import torch

from ..build import CudaKernel, CudaLibrary
from .ref import lowrank_matmul_ref, lut_matmul_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
LUT_LIBRARY = CudaLibrary(_CSRC / "lut_matmul.cu")
LOWRANK_LIBRARY = CudaLibrary(_CSRC / "lowrank_matmul.cu")
LIBRARIES = (LUT_LIBRARY, LOWRANK_LIBRARY)

_P, _I = ctypes.c_void_p, ctypes.c_int
LUT = CudaKernel("amr_matmul_int8_lut", LUT_LIBRARY, "amr_lut_matmul",
                 [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P])
LUT_GROUPED = CudaKernel("amr_matmul_int8_lut_grouped", LUT_LIBRARY, "amr_lut_matmul_grouped",
                         [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P])
LOWRANK = CudaKernel("amr_matmul_int8", LOWRANK_LIBRARY, "amr_lowrank_matmul",
                     [_P] * 7 + [_I] * 6 + [_P])
KERNELS = (LUT, LUT_GROUPED, LOWRANK)

LOWRANK_RANKS = (1, 2, 4, 8, 16)  # ranks the low-rank kernel is instantiated for
LOWRANK_CHUNK = 256               # kChunk in lowrank_matmul.cu: K per chunk
_LOWRANK_CGB = (16, 8, 4, 2)      # column groups of 4 per block, widest first
_LUT_ROWS, _LUT_COLS = 16, 256    # kRows, kThreads in lut_matmul.cu
_MIN_K_CHUNK = 128


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors on one device; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"AMR matmul kernels take CPU or CUDA tensors, got {dev}")
    return dev.type


def _check(name: str, t: torch.Tensor, dtypes: tuple, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


def _check_cuda(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _check_table(table: torch.Tensor) -> None:
    _check("table", table, (torch.int16, torch.int32), 2)
    if tuple(table.shape) != (256, 256):
        raise ValueError(f"table must be (256, 256), got {tuple(table.shape)}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k_chunk(tiles: int, K: int, device: torch.device) -> int:
    """K per block: split K until about two blocks per SM are in flight.

    The int32 atomics that join the splits are exact in any order, so the
    split changes the time, never the result.
    """
    splits = min(max(1, math.ceil(2 * _sm_count(device) / tiles)),
                 max(1, math.ceil(K / _MIN_K_CHUNK)))
    return math.ceil(K / splits)


@lru_cache(maxsize=256)
def lowrank_launch_shape(M: int, N: int, K: int, sms: int) -> tuple[int, int, int, int]:
    """(rt, cgb, chunks, tiles) of the low-rank kernel: rows per thread (2 up
    to M = 2, else 8), column groups of 4 per block, K chunks and tiles.

    The chunk count depends on K alone, so the summation order does; cgb
    is the widest that still gives a tile per SM, or 2.  The kernel
    launches min(tiles, the blocks that fit on the card) blocks.
    """
    rt = 2 if M <= 2 else 8
    chunks = math.ceil(K / LOWRANK_CHUNK)
    for cgb in _LOWRANK_CGB:
        tiles = math.ceil(N / (4 * cgb)) * math.ceil(M / rt) * chunks
        if tiles >= sms:
            break
    return rt, cgb, chunks, tiles


# per (device, stream): the low-rank kernel's chunk counters, which it leaves zero
_LOWRANK_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _lowrank_counters(device: torch.device, stream: int, n: int) -> int:
    """Address of at least n zero int32 counters for ``stream``."""
    key = (device.index, stream)
    counters = _LOWRANK_COUNTERS.get(key)
    if counters is None or counters.numel() < n:
        counters = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _LOWRANK_COUNTERS[key] = counters
    return counters.data_ptr()


def _lut_tiles(M: int, N: int) -> int:
    return math.ceil(M / _LUT_ROWS) * math.ceil(N / _LUT_COLS)


def amr_matmul_int8_lut(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, b (K, N) int8, table (256, 256) int16 or int32 -> int32
    (M, N), ``out[m, n] = sum_k table[a[m, k] + 128, b[k, n] + 128]``.

    An int16 table must hold every product exactly (``lut.table_max_abs``
    <= 32767); it halves the table's cache footprint.
    """
    _check("a", a, (torch.int8,), 2)
    _check("b", b, (torch.int8,), 2)
    _check_table(table)
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"contraction mismatch: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    N = b.shape[1]
    if _route(a, b, table) == "cpu":
        return lut_matmul_ref(a, b, table)
    _check_cuda(a=a, b=b, table=table)
    out = torch.zeros((M, N), dtype=torch.int32, device=a.device)  # split-K adds atomically
    LUT(a.data_ptr(), b.data_ptr(), table.data_ptr(), int(table.dtype == torch.int16),
        out.data_ptr(), M, N, K, _k_chunk(_lut_tiles(M, N), K, a.device), _stream())
    return out


def amr_matmul_int8_lut_grouped(a: torch.Tensor, b: torch.Tensor,
                                table: torch.Tensor) -> torch.Tensor:
    """a (G, M, K) int8, b (G, K, N) int8, table as ``amr_matmul_int8_lut``
    -> int32 (G, M, N), one independent gather matmul per group."""
    _check("a", a, (torch.int8,), 3)
    _check("b", b, (torch.int8,), 3)
    _check_table(table)
    G, M, K = a.shape
    if b.shape[0] != G or b.shape[1] != K:
        raise ValueError(f"grouped shapes mismatch: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    N = b.shape[2]
    if _route(a, b, table) == "cpu":
        return lut_matmul_ref(a, b, table)
    _check_cuda(a=a, b=b, table=table)
    out = torch.zeros((G, M, N), dtype=torch.int32, device=a.device)  # split-K adds atomically
    LUT_GROUPED(a.data_ptr(), b.data_ptr(), table.data_ptr(), int(table.dtype == torch.int16),
                out.data_ptr(), G, M, N, K,
                _k_chunk(G * _lut_tiles(M, N), K, a.device), _stream())
    return out


def amr_matmul_int8(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, b (K, N) int8, u/v (256, r) float32 -> float32 (M, N)
    approximate products ``A @ B + U[A] . V[B]``.

    The CUDA kernel sums in an order fixed by K alone (see
    ``csrc/lowrank_matmul.cu``) and takes r in ``LOWRANK_RANKS``.  Its
    output and the chunk partials share one allocation; the chunk counters
    are cached per device and stream.
    """
    _check("a", a, (torch.int8,), 2)
    _check("b", b, (torch.int8,), 2)
    _check("u", u, (torch.float32,), 2)
    _check("v", v, (torch.float32,), 2)
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"contraction mismatch: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if u.shape != v.shape or u.shape[0] != 256:
        raise ValueError(f"u, v must both be (256, r), got {tuple(u.shape)}, {tuple(v.shape)}")
    N, r = b.shape[1], u.shape[1]
    if _route(a, b, u, v) == "cpu":
        return lowrank_matmul_ref(a, b, u, v)
    if r not in LOWRANK_RANKS:
        raise ValueError(f"the low-rank CUDA kernel takes rank in {LOWRANK_RANKS}, got {r}")
    _check_cuda(a=a, b=b, u=u, v=v)
    if u.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("u and v must start on 16-byte boundaries for the CUDA kernel")
    rt, cgb, chunks, _ = lowrank_launch_shape(M, N, K, _sm_count(a.device))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    buf = torch.empty((1 + (chunks if chunks > 1 else 0), M, N), dtype=torch.float32,
                      device=a.device)  # out, then the chunk partials
    counters = (_lowrank_counters(a.device, stream, math.ceil(N / (4 * cgb)) * math.ceil(M / rt))
                if chunks > 1 else 0)
    out = buf.data_ptr()
    LOWRANK(a.data_ptr(), b.data_ptr(), u.data_ptr(), v.data_ptr(), out + 4 * M * N, counters,
            out, M, N, K, r, rt, cgb, stream)
    return buf[0]
