"""Wrappers of the hand-written fused AMR attention kernels (CUDA C++, ``csrc/``).

Two kernels, each replacing one Pallas kernel of the JAX package's
``kernels/attn_fused/kernel.py``:

* ``attn_fused_lut``    -> ``_attn_fused_lut_kernel``: QK^T and PV gathered
  from the product table;
* ``attn_fused_inject`` -> ``_make_attn_fused_inject_kernel``: QK^T and PV
  replayed on a schedule's reduction circuit (the device code of the replay
  matmul, ``inject_replay/csrc/replay_device.cuh``).

Between the products both run the float32 chain of ``csrc/attn_softmax.cuh``:
rescale, mask, softmax with the row sum in a fixed order, int8
re-quantization of the probabilities.  Both take the int8 operands and the
scales the op makes (``ops.quantize_operands``) and return (G, M, P)
float32, bit for bit their plain versions in ``ref.py``.

A tensor's device decides the route: CPU tensors go to the plain versions;
CUDA tensors go to the kernel, which raises on what it does not take.  A
block holds the scores of its rows (4 T bytes a row) in shared memory, so
the kernels take T up to about 57,000 (the LUT kernel) or 47,000 (the
inject kernel, whose wire slots share the block's memory).  Each wrapper checks
device, dtype, shape and contiguity, allocates the output, launches on
PyTorch's current stream and counts the launch on its ``CudaKernel``
(``LUT``, ``INJECT``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.engine import CompiledInjector

from ..amr_matmul.kernel import _check_cuda, _check_table, _route, _stream
from ..build import CudaKernel, CudaLibrary
from ..inject_replay import kernel as rkernel
from .ref import attn_fused_inject_ref, attn_fused_lut_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOFTMAX = _CSRC / "attn_softmax.cuh"
LUT_LIBRARY = CudaLibrary(_CSRC / "attn_fused_lut.cu", (_SOFTMAX,))
INJECT_LIBRARY = CudaLibrary(_CSRC / "attn_fused_inject.cu", (_SOFTMAX, rkernel.DEVICE_HEADER),
                             rkernel.DEFINES)
LIBRARIES = (LUT_LIBRARY, INJECT_LIBRARY)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LUT = CudaKernel("attn_fused_lut", LUT_LIBRARY, "attn_fused_lut",
                 [_P] * 8 + [_I, _P, _F] + [_I] * 7 + [_P])
INJECT = CudaKernel("attn_fused_inject", INJECT_LIBRARY, "attn_fused_inject",
                    [_P] * 9 + [_I, _P, _P] + [_I] * 3 + [_F] + [_I] * 11 + [_P])
KERNELS = (LUT, INJECT)

MAX_ROWS = 16                 # kMaxRows: rows of a sub-tile
SMEM_LIMIT = 232448           # shared memory a block may use on Hopper (227 KB)
_SMEM_TARGET = 96 * 1024      # a sub-tile's share, so that two blocks fit an SM
# blocks the default row tile keeps in flight: two 512-thread LUT blocks per
# SM; four 128-thread replay blocks, as the replay matmul runs best
_TILE_BLOCKS = {"lut": 256, "inject": 512}
_INJECT_FIXED_WORDS = 256 + 2 * rkernel.POSITIONS + MAX_ROWS


def default_row_tile(G: int, M: int, method: str) -> int:
    """The largest divisor of M up to 16 that leaves at least 256 (lut) or
    512 (inject) blocks of G * M / bm, else 1: a long prefill fills the card
    with blocks of several rows, a decode takes one row a block."""
    for bm in range(min(MAX_ROWS, M), 0, -1):
        if M % bm == 0 and G * (M // bm) >= _TILE_BLOCKS[method]:
            return bm
    return 1


def _sub_tile_rows(bm: int, fixed: int, per_row: int, T: int) -> int:
    """Rows a block holds at once: up to 16 (and bm) within the target share
    of shared memory; raises when one row's scores do not fit at all."""
    if fixed + per_row > SMEM_LIMIT:
        raise ValueError(f"the fused attention kernels hold a row's {T} scores in shared "
                         f"memory: T={T} needs {fixed + per_row} bytes, more than a "
                         f"block's {SMEM_LIMIT}")
    return max(1, min(MAX_ROWS, bm, (_SMEM_TARGET - fixed) // per_row))


def _lut_rows(bm: int, T: int, D: int, P: int) -> int:
    """The LUT kernel's sub-tile: a power of two (its row count is a
    template parameter); a row takes its scores, its int32 PV sums and its
    q bytes."""
    rows = _sub_tile_rows(bm, 4 * MAX_ROWS, 4 * (T + P) + D, T)
    return 1 << (rows.bit_length() - 1)


def _check_operands(q, kt, v, sq, sk, sv, mask) -> tuple[int, int, int, int, int]:
    for name, t in (("q", q), ("kt", kt), ("v", v)):
        if t.dtype != torch.int8 or t.dim() != 3:
            raise TypeError(f"{name} must be a 3-D int8 tensor, got {t.dtype} {tuple(t.shape)}")
    G, M, D = q.shape
    T, P = kt.shape[-1], v.shape[-1]
    want = {"kt": (G, D, T), "v": (G, T, P), "sq": (G, M, 1), "sk": (G, 1, T),
            "sv": (G, 1, P), "mask": (G, M, T)}
    got = {"kt": kt, "v": v, "sq": sq, "sk": sk, "sv": sv, "mask": mask}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for q {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    for name in ("sq", "sk", "sv"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {got[name].dtype}")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be int32, got {mask.dtype}")
    return G, M, D, T, P


def _check_bm(M: int, bm: int) -> None:
    """An explicit ``bm`` must divide M; the result never depends on it."""
    if bm < 1 or M % bm:
        raise ValueError(
            f"bm={bm} does not tile the problem: m={M} is not a multiple (the grid would "
            f"miss a partial tile); pass None to take the default row tile")


def attn_fused_lut(q, kt, v, sq, sk, sv, mask, table: torch.Tensor, *, scale: float,
                   bm: int | None = None) -> torch.Tensor:
    """Fused attention with both products gathered from ``table`` (256, 256)
    int16 or int32 -> (G, M, P) float32.  ``bm`` query rows per block (a
    divisor of M; None = ``default_row_tile``) change the time, never a bit.
    An int16 table must hold every product exactly."""
    G, M, D, T, P = _check_operands(q, kt, v, sq, sk, sv, mask)
    _check_table(table)
    bm = default_row_tile(G, M, "lut") if bm is None else bm
    _check_bm(M, bm)
    if _route(q, kt, v, sq, sk, sv, mask, table) == "cpu":
        return attn_fused_lut_ref(q, kt, v, sq, sk, sv, mask, table, scale)
    _check_cuda(q=q, kt=kt, v=v, sq=sq, sk=sk, sv=sv, mask=mask, table=table)
    rows = _lut_rows(bm, T, D, P)
    out = torch.empty((G, M, P), dtype=torch.float32, device=q.device)
    LUT(q.data_ptr(), kt.data_ptr(), v.data_ptr(), sq.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        mask.data_ptr(), table.data_ptr(), int(table.dtype == torch.int16), out.data_ptr(),
        scale, G, M, D, T, P, bm, rows, _stream())
    return out


def attn_fused_inject(inj: CompiledInjector, q, kt, v, sq, sk, sv, mask, *, scale: float,
                      bm: int | None = None) -> torch.Tensor:
    """Fused attention with both products replayed on ``inj``'s circuit
    -> (G, M, P) float32; ``bm`` as in ``attn_fused_lut``.  The caller
    bounds D and T times ``inj.max_abs_product`` below 2**31."""
    G, M, D, T, P = _check_operands(q, kt, v, sq, sk, sv, mask)
    bm = default_row_tile(G, M, "inject") if bm is None else bm
    _check_bm(M, bm)
    if _route(q, kt, v, sq, sk, sv, mask) == "cpu":
        return attn_fused_inject_ref(inj, q, kt, v, sq, sk, sv, mask, scale)
    _check_cuda(q=q, kt=kt, v=v, sq=sq, sk=sk, sv=sv, mask=mask)
    prog, ops, fin, vbits = rkernel.program_tensors(inj, q.device)
    fixed = 4 * (prog.n_slots * rkernel.THREADS + rkernel.THREADS * prog.n_opbits
                 + prog.ops.size + _INJECT_FIXED_WORDS)
    rows = _sub_tile_rows(bm, fixed, 4 * T, T)
    qk_wpb, qk_rpb, _ = rkernel.block_shape(rows, -(-T // 32))
    pv_wpb, pv_rpb, _ = rkernel.block_shape(rows, -(-P // 32))
    out = torch.empty((G, M, P), dtype=torch.float32, device=q.device)
    INJECT(q.data_ptr(), kt.data_ptr(), v.data_ptr(), sq.data_ptr(), sk.data_ptr(),
           sv.data_ptr(), mask.data_ptr(), out.data_ptr(), ops.data_ptr(), prog.ops.shape[0],
           fin.data_ptr(), vbits.data_ptr(), prog.n_opbits, prog.n_slots, prog.offset, scale,
           G, M, D, T, P, bm, rows, qk_wpb, qk_rpb, pv_wpb, pv_rpb, _stream())
    return out
