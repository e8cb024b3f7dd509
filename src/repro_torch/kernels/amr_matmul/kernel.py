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
allocates its outputs, launches on PyTorch's current stream and counts the
launch on its ``CudaKernel`` (``LUT``, ``LUT_GROUPED``, ``LOWRANK``).  One
call is one launch: the K splits of the gather and low-rank kernels meet
in the kernel (through per-stream counters and, for the gather kernels, a
per-stream accumulator, all of which the kernels leave zero), with no
zero-fill before it.

The two gather kernels are one CUDA body (``csrc/lut_matmul.cu``, its
tile loop in ``csrc/lut_gather.cuh``, which the fused attention LUT kernel
also runs): tiles of RT rows x 4 cg columns x k_chunk of K, 512 threads a block, persistent
blocks, the int16 table staged in shared memory where the work pays for
it (``lut_launch_plan``).  Its bound: a gather and an add a product, and
the operands' bytes (0.0101 ms at (2, 2048, 16384)).  Measured by
chip_smoke.py on an H100 80GB HBM3 at 700 W, device time: 0.032 ms at
(2, 2048, 16384) and (2, 16384, 2048), 0.203 ms at (16, 2048, 16384), the
grouped served shapes 0.003-0.005 ms but 0.041 ms at (32, 256, 128, 64).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from ..build import CudaKernel, CudaLibrary
from .ref import lowrank_matmul_ref, lut_matmul_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
GATHER_HEADER = _CSRC / "lut_gather.cuh"  # the gather's tile loop, shared with attn_fused
LUT_LIBRARY = CudaLibrary(_CSRC / "lut_matmul.cu", (GATHER_HEADER,))
LOWRANK_LIBRARY = CudaLibrary(_CSRC / "lowrank_matmul.cu")
LIBRARIES = (LUT_LIBRARY, LOWRANK_LIBRARY)

_P, _I = ctypes.c_void_p, ctypes.c_int
LUT = CudaKernel("amr_matmul_int8_lut", LUT_LIBRARY, "amr_lut_matmul",
                 [_P, _P, _P, _I, _P, _P, _P] + [_I] * 7 + [_P])
LUT_GROUPED = CudaKernel("amr_matmul_int8_lut_grouped", LUT_LIBRARY, "amr_lut_matmul_grouped",
                         [_P, _P, _P, _I, _P, _P, _P] + [_I] * 8 + [_P])
LOWRANK = CudaKernel("amr_matmul_int8", LOWRANK_LIBRARY, "amr_lowrank_matmul",
                     [_P] * 7 + [_I] * 6 + [_P])
KERNELS = (LUT, LUT_GROUPED, LOWRANK)

LOWRANK_RANKS = (1, 2, 4, 8, 16)  # ranks the low-rank kernel is instantiated for
LOWRANK_CHUNK = 256               # kChunk in lowrank_matmul.cu: K per chunk
_LOWRANK_CGB = (16, 8, 4, 2)      # column groups of 4 per block, widest first
LUT_THREADS = 512                 # kThreads in lut_matmul.cu
LUT_ROWS = (16, 8, 4, 2, 1)       # rows a tile, widest first
LUT_MAX_CG = 128                  # kMaxCg: column groups of 4 a block
LUT_A_ENTRIES = 16384             # kAEntries: rt x k_chunk staged A row addresses at most
LUT_TABLE_BYTES = 256 * 256 * 2   # the staged int16 table
LUT_STAGE_MIN_PRODUCTS = 1 << 24  # least products for which the table is staged
_LUT_TILE_COST = 64               # a tile's fixed cost, in gathers a thread
_LUT_GROUP_COST = 8               # a group of 4 k's loads and byte picks, likewise


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


class LutPlan(NamedTuple):
    """A gather kernel launch: rows a tile, column groups of 4 a block, K a
    tile, the K splits, the tiles, and whether the table is staged."""
    rt: int
    cg: int
    k_chunk: int
    splits: int
    tiles: int
    staged: bool


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def fills_the_card(tiles: int, sms: int) -> bool:
    """A gather launch fills the card when its first round of tiles (one
    block an SM) leaves at most 1/16 of the SMs idle."""
    return 16 * tiles >= 15 * sms


@lru_cache(maxsize=256)
def lut_launch_plan(G: int, M: int, N: int, K: int, sms: int, int16: bool) -> LutPlan:
    """The gather kernels' launch plan.

    A block's 512 threads are cg groups of 4 columns (at most what N
    needs, from 128 down to 4) x 512 / cg k-lanes.  Among the cg, rt (at
    most the power of two that fits M) and k_chunk (a multiple of 4) whose
    tiles fill the card (``fills_the_card``, where any do), the plan
    minimises rounds x (groups of 4 k in a lane x (16 rt gathers + a
    group's loads) + a tile's fixed cost), where a round is one tile on
    each SM; ties go to wider blocks and rows and fewer splits.  Fine
    splits fill the card at small N; coarse ones keep the per-tile cost (A
    staged, the k-lanes' sums met, the splits' sums joined) small.  The int16
    table is staged into shared memory when the call has at least
    ``LUT_STAGE_MIN_PRODUCTS`` products.  int32 sums are exact in any
    order: the plan changes the time, never the result.
    """
    best = None
    cg_fit = min(LUT_MAX_CG, max(4, _pow2_at_least(math.ceil(N / 4))))
    for cg in (c for c in (128, 64, 32, 16, 8, 4) if c <= cg_fit):
        lanes = LUT_THREADS // cg
        col_tiles = math.ceil(N / (4 * cg))
        for rt in (r for r in LUT_ROWS if r <= _pow2_at_least(M)):
            base = G * math.ceil(M / rt) * col_tiles
            max_chunk = min(4 * math.ceil(K / 4), LUT_A_ENTRIES // rt)
            s_min = math.ceil(K / max_chunk)
            s_max = max(s_min, min(math.ceil(K / 4), math.ceil(4 * sms / base)))
            for s in range(s_min, s_max + 1):
                k_chunk = 4 * math.ceil(K / (4 * s))
                splits = math.ceil(K / k_chunk)
                tiles = base * splits
                per_lane = math.ceil(k_chunk / (4 * lanes))
                cost = (math.ceil(tiles / sms)
                        * (per_lane * (16 * rt + _LUT_GROUP_COST) + _LUT_TILE_COST))
                key = (not fills_the_card(tiles, sms), cost)
                if best is None or key < best[0]:
                    best = (key, LutPlan(rt, cg, k_chunk, splits, tiles, False))
    staged = bool(int16) and G * M * N * K >= LUT_STAGE_MIN_PRODUCTS
    return best[1]._replace(staged=staged)


def lut_smem_bytes(plan: LutPlan) -> int:
    """Dynamic shared memory of a gather launch: the staged table, the
    tile's sums and its A rows' table-row addresses (as ``launch`` in
    lut_matmul.cu)."""
    return ((LUT_TABLE_BYTES if plan.staged else 0) + 16 * plan.rt * plan.cg
            + 4 * plan.rt * plan.k_chunk)


# per (device, stream, use): int32 arrays the kernels leave zero between calls
_ZEROS: dict[tuple[int, int, str], torch.Tensor] = {}


def _zeros(device: torch.device, stream: int, n: int, use: str) -> int:
    """Address of at least n int32 zeros for ``stream``, one array per use
    (``"counters"``: the gather and low-rank kernels' tile counters, which
    they share since they run in stream order; ``"sums"``: the gather
    kernels' split accumulator).  The kernels leave them zero."""
    key = (device.index, stream, use)
    zeros = _ZEROS.get(key)
    if zeros is None or zeros.numel() < n:
        zeros = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _ZEROS[key] = zeros
    return zeros.data_ptr()


def lut_matmul_with_plan(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                         plan: LutPlan) -> torch.Tensor:
    """The gather kernel on CUDA tensors under ``plan``: a (M, K) @ b (K, N)
    on ``LUT`` or a (G, M, K) @ b (G, K, N) on ``LUT_GROUPED``.  The
    wrappers pass ``lut_launch_plan``'s plan; the card tests pass others,
    so that every route is held to the plain version."""
    grouped = a.dim() == 3
    G = a.shape[0] if grouped else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    out = torch.empty((G, M, N) if grouped else (M, N), dtype=torch.int32, device=a.device)
    split = plan.splits > 1
    acc = _zeros(a.device, stream, G * M * N, "sums") if split else 0
    counters = _zeros(a.device, stream, plan.tiles // plan.splits, "counters") if split else 0
    args = [a.data_ptr(), b.data_ptr(), table.data_ptr(), int(table.dtype == torch.int16),
            out.data_ptr(), acc, counters] + ([G] if grouped else [])
    (LUT_GROUPED if grouped else LUT)(*args, M, N, K, plan.rt, plan.cg, plan.k_chunk,
                                      int(plan.staged), stream)
    return out


def amr_matmul_int8_lut(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, b (K, N) int8, table (256, 256) int16 or int32 -> int32
    (M, N), ``out[m, n] = sum_k table[a[m, k] + 128, b[k, n] + 128]``.

    An int16 table must hold every product exactly (``lut.table_max_abs``
    <= 32767); it halves the table's footprint, so that a block can stage
    it in shared memory.
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
    plan = lut_launch_plan(1, M, N, K, _sm_count(a.device), table.dtype == torch.int16)
    return lut_matmul_with_plan(a, b, table, plan)


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
    plan = lut_launch_plan(G, M, N, K, _sm_count(a.device), table.dtype == torch.int16)
    return lut_matmul_with_plan(a, b, table, plan)


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
    counters = (_zeros(a.device, stream, math.ceil(N / (4 * cgb)) * math.ceil(M / rt),
                       "counters") if chunks > 1 else 0)
    out = buf.data_ptr()
    LOWRANK(a.data_ptr(), b.data_ptr(), u.data_ptr(), v.data_ptr(), out + 4 * M * N, counters,
            out, M, N, K, r, rt, cgb, stream)
    return buf[0]
