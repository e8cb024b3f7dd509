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
CUDA tensors go to the kernel, which raises on what it does not take.
Both kernels split T over blocks (``csrc/attn_tsplit.cuh``;
``lut_attn_launch_plan``, ``inject_launch_plan``): their scores go to a
per-stream scratch in device memory and their PV sums meet in a per-stream
accumulator that the kernels leave zero, so they take any T and a call is
one launch; where T is one slice (for lut, and the row tiles fit one
wave), a block takes its row tile whole, scores in shared memory.  The
LUT kernel runs both products on the gather matmul's tile loop
(``amr_matmul/csrc/lut_gather.cuh``), with the int16 table staged in shared memory
where the call has enough products.  Each wrapper checks device, dtype,
shape and contiguity, allocates the output, launches on PyTorch's current
stream and counts the launch on its ``CudaKernel`` (``LUT``, ``INJECT``).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.core.engine import CompiledInjector

from ..amr_matmul import kernel as mkernel
from ..amr_matmul.kernel import _check_cuda, _check_table, _pow2_at_least, _route, _sm_count, _zeros
from ..build import CudaKernel, CudaLibrary
from ..inject_replay import kernel as rkernel
from .ref import attn_fused_inject_ref, attn_fused_lut_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOFTMAX = _CSRC / "attn_softmax.cuh"
TSPLIT_HEADER = _CSRC / "attn_tsplit.cuh"  # the T split's join, for any fused kernel
LUT_LIBRARY = CudaLibrary(_CSRC / "attn_fused_lut.cu",
                          (_SOFTMAX, TSPLIT_HEADER, mkernel.GATHER_HEADER))
INJECT_LIBRARY = CudaLibrary(_CSRC / "attn_fused_inject.cu",
                             (_SOFTMAX, TSPLIT_HEADER, rkernel.DEVICE_HEADER), rkernel.DEFINES)
LIBRARIES = (LUT_LIBRARY, INJECT_LIBRARY)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LUT = CudaKernel("attn_fused_lut", LUT_LIBRARY, "attn_fused_lut",
                 [_P] * 8 + [_I] + [_P] * 3 + [_F] + [_I] * 13 + [_P])
INJECT = CudaKernel("attn_fused_inject", INJECT_LIBRARY, "attn_fused_inject",
                    [_P] * 11 + [_I, _P, _P] + [_I] * 3 + [_F] + [_I] * 13 + [_P])
KERNELS = (LUT, INJECT)

MAX_ROWS = 16                 # kMaxRows: rows of a sub-tile (lut); rows of a replay tile
SMEM_LIMIT = 232448           # shared memory a block may use on Hopper (227 KB)
SM_SMEM = 233472              # shared memory of an SM (228 KB), 1 KB of it reserved a block
LUT_MAX_CG = 64               # kMaxCg: column groups of 4 of a product's tile
LUT_A_WORDS = 2048            # kAWords: the staged A's words
_LUT_QK_CG = 32               # a QK^T tile's 128 columns: the mask skips whole tiles
_INJECT_MAX_PER_SM = 4        # inject blocks an SM holds at most (registers)
INJECT_MAX_ROWS = 8           # rows of an inject row tile: more leave a block fewer k-lanes
TILE_WORDS = 3                # tsplit::kTileWords: counters of a row tile


@lru_cache(maxsize=256)
def default_row_tile(G: int, M: int, method: str, T: int, sms: int) -> int:
    """Rows a row tile takes, a divisor of M.  T is split over blocks, so
    the largest up to 16 (lut) or 8 (inject) whose row tiles, cut into
    slices of one 32-column word, give at least ``sms`` (the card's SM
    count) items, else 1 (a short cache spreads its rows instead).  A row
    tile reads K^T and V once for all its rows: lut gathers a column
    offset for 16 rows at once; inject packs K^T and V once a tile, but 16
    rows leave its block half the k-lanes of 8 (chip_smoke's phase 4 times
    the row tiles of both)."""
    if T < 1 or sms < 1:
        raise ValueError(f"the row tile depends on T and the SM count, got {T}, {sms}")
    for bm in range(min(INJECT_MAX_ROWS if method == "inject" else MAX_ROWS, M), 0, -1):
        if M % bm == 0 and G * (M // bm) * math.ceil(T / 32) >= sms:
            return bm
    return 1


class LutAttnPlan(NamedTuple):
    """A launch of the fused LUT kernel: rows a tile and a sub-tile (the
    kernel's RT), the T slice in 32-column words and the slices, the column
    groups of 4 of a QK^T tile and of a PV tile, whether the int16 table is
    staged in shared memory, whether a block takes a whole row tile (one
    slice: scores in shared memory, no hand-off), the blocks (one a row tile
    when whole, else persistent, at most one an SM), a block's shared memory
    in bytes, and the int32 state (zero between calls) and float32 score
    scratch the launch takes, in words (none when whole; the scratch holds
    the scores, then each row's ps, max and sum)."""
    bm: int
    rt: int
    slice_words: int
    slices: int
    qk_cg: int
    pv_cg: int
    staged: bool
    whole: bool
    blocks: int
    smem: int
    state_words: int
    score_words: int


def _col_groups(cols: int, most: int) -> int:
    """Column groups of 4 of a tile over ``cols`` columns: a power of two from 4 to ``most``."""
    return min(most, max(4, _pow2_at_least(math.ceil(cols / 4))))


def lut_attn_plan(G: int, M: int, D: int, T: int, P: int, bm: int, sms: int, *,
                  slice_words: int, staged: bool, whole: bool) -> LutAttnPlan:
    """The fused LUT kernel's launch for a T slice of ``slice_words``
    words, a table route and a whole or split row tile: the sub-tile (the
    power of two at or above bm, at most 16), a QK^T tile over the slice's
    columns (at most 128: the mask skips a tile whose scores it removes from
    every row), a PV tile over P (at most 256 columns), and what follows
    (``smem_bytes`` in attn_fused_lut.cu).  ``lut_attn_launch_plan`` picks
    the wrapper's; the card tests and chip_smoke run others."""
    n_words = math.ceil(T / 32)
    slices = math.ceil(n_words / slice_words)
    if whole and slices != 1:
        raise ValueError(f"a whole row tile takes all of T: {slices} slices of {slice_words} words")
    tiles = G * (M // bm)
    rt = _pow2_at_least(min(bm, MAX_ROWS))
    qk_cg = _col_groups(min(T, 32 * slice_words), _LUT_QK_CG)
    pv_cg = _col_groups(P, LUT_MAX_CG)
    slab = bm * (32 * n_words + 1) if whole else 0
    smem = ((mkernel.LUT_TABLE_BYTES if staged else 0) + 16 * rt * max(qk_cg, pv_cg)
            + 4 * LUT_A_WORDS + 4 * slab)
    return LutAttnPlan(bm, rt, slice_words, slices, qk_cg, pv_cg, staged, whole,
                       tiles if whole else min(2 * tiles * slices, sms), smem,
                       0 if whole else 1 + TILE_WORDS * tiles + G * M * P,
                       0 if whole else G * M * 32 * n_words + 3 * G * M)


@lru_cache(maxsize=256)
def lut_attn_launch_plan(G: int, M: int, D: int, T: int, P: int, bm: int, sms: int,
                         int16: bool) -> LutAttnPlan:
    """The T split (``csrc/attn_tsplit.cuh``) and tiles of one call.

    T is cut into slices of whole 32-column words, as few as give one wave
    of QK^T items, one an SM, over the G M / bm row tiles: the long decode
    (2 row tiles of 8 rows) cuts its 256 words into 64 slices of 4, a
    served decode (T = 24) or prefill (T = 16) keeps one slice, and so does
    a long prefill whose row tiles fill the card.  With one slice and at
    most one row tile an SM, a block takes its row tile whole where its
    scores fit in shared memory (QK^T, the softmax and PV in one block, no
    hand-off); with more row tiles than SMs (the long prefill's 512) the
    split join's persistent blocks stage the table once and take the tiles
    by ticket, which balances the causal tiles' uneven work (on an H100,
    1.26 ms against 1.32 whole at (1, 8192, 1024): chip_smoke phase 4,
    PERF.md).  The int16 table is staged in shared memory once a block
    where the call has at least ``LUT_STAGE_MIN_PRODUCTS`` products, as in
    the gather matmul; the int32 table never is.  int32 sums are exact in
    any order and the softmax's row sum has one order whatever the
    slicing, so the plan changes the time, never a bit.
    """
    n_words = math.ceil(T / 32)
    want = min(n_words, max(1, math.ceil(sms / (G * (M // bm)))))
    slice_words = math.ceil(n_words / want)
    staged = bool(int16) and G * M * T * (D + P) >= mkernel.LUT_STAGE_MIN_PRODUCTS
    plan = lut_attn_plan(G, M, D, T, P, bm, sms, slice_words=slice_words, staged=staged,
                         whole=slice_words >= n_words and G * (M // bm) <= sms)
    if plan.whole and plan.smem > SMEM_LIMIT:
        plan = lut_attn_plan(G, M, D, T, P, bm, sms, slice_words=slice_words, staged=staged,
                             whole=False)
    return plan


class InjectPlan(NamedTuple):
    """A launch of the fused inject kernel: rows a tile, the T slice in
    32-column words and the slices, the replay tiles of QK^T and PV (words
    x rows), the k values a thread replays at once, whether a block takes a
    whole row tile (one slice: scores in shared memory, no hand-off), the
    blocks (else a QK^T and a PV item per row tile and slice), a block's
    shared memory in bytes, and the int32 state (zero between calls) and
    float32 scores scratch the launch takes, in words."""
    bm: int
    slice_words: int
    slices: int
    qk_wpb: int
    qk_rpb: int
    pv_wpb: int
    pv_rpb: int
    items: int
    whole: bool
    blocks: int
    smem: int
    state_words: int
    score_words: int


def inject_smem_bytes(items: int, n_slots: int, n_opbits: int, n_records: int,
                      rpb: int, slab: int = 0) -> int:
    """A block's dynamic shared memory (``smem_bytes`` in attn_fused_inject.cu):
    the program, the wire slots of ``items`` k values a thread, the packed B
    of a tile of ``rpb`` rows (the fewer rows of the QK^T and PV tiles:
    more k-lanes), the operand bits, the final bits' slots and ``slab``
    floats of scores and scales (a block that takes a whole row tile)."""
    return 4 * (2 * n_records + n_slots * items * rkernel.THREADS
                + items * n_opbits * (rkernel.THREADS // rpb) + 256 + 2 * rkernel.POSITIONS
                + slab)


@lru_cache(maxsize=256)
def inject_launch_plan(G: int, M: int, D: int, T: int, P: int, bm: int, sms: int,
                       n_slots: int, n_opbits: int, n_records: int) -> InjectPlan:
    """The T split (``csrc/attn_tsplit.cuh``) and replay tiles of one call.

    T is cut into slices of whole 32-column words, as few as give one wave
    of QK^T items (the blocks the SMs hold at the kernel's shared memory, at
    most ``_INJECT_MAX_PER_SM`` a SM) over the G M / bm row tiles: the long
    decode splits its 256 words, a served decode (T = 24) or prefill (T =
    16) keeps one slice.  With one slice a block takes its row tile whole
    (``whole``: the scores stay in shared memory, as the rows' do where they
    fit, and QK^T, the softmax and PV run in one block with no hand-off).
    The replay tiles are ``block_shape``'s for the tile's rows (at most 16)
    against the slice's words (QK^T) and P's words (PV).  A thread replays
    ITEMS k values at once where the wire slots fit and both products take
    more than one step of one k a thread (else 1: the extra items would
    replay nothing, as in a served prefill's PV over 16 keys).  int32 sums
    are exact in any order and the softmax's row sum has one order whatever
    the slicing, so the plan changes the time, never a bit.
    """
    n_words = math.ceil(T / 32)
    rows = min(bm, MAX_ROWS)
    tiles = G * (M // bm)
    # the fewest rows a tile of the call takes (block_shape gives rpb <= the
    # power of two at or above rows): its packed B words bound the wave
    rpb = min(rkernel.block_shape(rows, w)[1] for w in (n_words, math.ceil(P / 32)))
    smem = inject_smem_bytes(rkernel.ITEMS, n_slots, n_opbits, n_records, rpb)
    per_sm = max(1, min(_INJECT_MAX_PER_SM, SM_SMEM // (smem + 1024)))
    want = min(n_words, max(1, math.ceil(per_sm * sms / tiles)))
    slice_words = math.ceil(n_words / want)
    slices = math.ceil(n_words / slice_words)
    qk_wpb, qk_rpb, qk_kpb = rkernel.block_shape(rows, slice_words)
    pv_wpb, pv_rpb, pv_kpb = rkernel.block_shape(rows, math.ceil(P / 32))
    rpb = min(qk_rpb, pv_rpb)
    slab = bm * (32 * n_words + 1)
    items = rkernel.ITEMS
    smem = inject_smem_bytes(items, n_slots, n_opbits, n_records, rpb)
    if smem > SMEM_LIMIT or D <= qk_kpb or min(T, 32 * slice_words) <= pv_kpb:
        items = 1
        smem = inject_smem_bytes(items, n_slots, n_opbits, n_records, rpb)
    whole = slices == 1 and smem + 4 * slab <= SMEM_LIMIT
    if whole:
        smem += 4 * slab
    return InjectPlan(bm, slice_words, slices, qk_wpb, qk_rpb, pv_wpb, pv_rpb, items, whole,
                      (1 if whole else 2) * tiles * slices, smem,
                      1 + TILE_WORDS * tiles + G * M * P, G * M * 32 * n_words + G * M)


# per (device, stream): the fused kernels' score scratch (float32, any content)
_SCORES: dict[tuple[int, int], torch.Tensor] = {}


def _score_scratch(device: torch.device, stream: int, n: int) -> int:
    key = (device.index, stream)
    scores = _SCORES.get(key)
    if scores is None or scores.numel() < n:
        scores = torch.empty(n, dtype=torch.float32, device=device)
        _SCORES[key] = scores
    return scores.data_ptr()


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
    int16 or int32 -> (G, M, P) float32.  ``bm`` query rows per tile (a
    divisor of M; None = ``default_row_tile``) change the time, never a bit,
    and so does the T split (``lut_attn_launch_plan``).  An int16 table must
    hold every product exactly."""
    G, M, D, T, P = _check_operands(q, kt, v, sq, sk, sv, mask)
    _check_table(table)
    if bm is not None:
        _check_bm(M, bm)
    if _route(q, kt, v, sq, sk, sv, mask, table) == "cpu":
        return attn_fused_lut_ref(q, kt, v, sq, sk, sv, mask, table, scale)
    _check_cuda(q=q, kt=kt, v=v, sq=sq, sk=sk, sv=sv, mask=mask, table=table)
    sms = _sm_count(q.device)
    bm = default_row_tile(G, M, "lut", T, sms) if bm is None else bm
    plan = lut_attn_launch_plan(G, M, D, T, P, bm, sms, table.dtype == torch.int16)
    return attn_fused_lut_with_plan(q, kt, v, sq, sk, sv, mask, table, scale=scale, plan=plan)


def attn_fused_lut_with_plan(q, kt, v, sq, sk, sv, mask, table: torch.Tensor, *, scale: float,
                             plan: LutAttnPlan) -> torch.Tensor:
    """The LUT kernel on checked CUDA operands under ``plan``: the wrapper
    passes ``lut_attn_launch_plan``'s, the card tests and chip_smoke others
    (``lut_attn_plan``), so that every row tile, T split and table route is
    held to the plain version."""
    G, M, D = q.shape
    T, P = kt.shape[-1], v.shape[-1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((G, M, P), dtype=torch.float32, device=q.device)
    state = scores = 0
    if not plan.whole:
        state = _zeros(q.device, stream, plan.state_words, "attn_tsplit")
        scores = _score_scratch(q.device, stream, plan.score_words)
    LUT(q.data_ptr(), kt.data_ptr(), v.data_ptr(), sq.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        mask.data_ptr(), table.data_ptr(), int(table.dtype == torch.int16), out.data_ptr(),
        state, scores, scale, G, M, D, T, P, plan.bm, plan.rt, plan.slice_words, plan.qk_cg,
        plan.pv_cg, int(plan.staged), int(plan.whole), plan.blocks, stream)
    return out


def attn_fused_inject(inj: CompiledInjector, q, kt, v, sq, sk, sv, mask, *, scale: float,
                      bm: int | None = None) -> torch.Tensor:
    """Fused attention with both products replayed on ``inj``'s circuit
    -> (G, M, P) float32; ``bm`` query rows per tile (a divisor of M; None
    = ``default_row_tile``) change the time, never a bit, and so does the
    T split (``inject_launch_plan``).  The caller bounds D and T times
    ``inj.max_abs_product`` below 2**31."""
    G, M, D, T, P = _check_operands(q, kt, v, sq, sk, sv, mask)
    if bm is not None:
        _check_bm(M, bm)
    if _route(q, kt, v, sq, sk, sv, mask) == "cpu":
        return attn_fused_inject_ref(inj, q, kt, v, sq, sk, sv, mask, scale)
    _check_cuda(q=q, kt=kt, v=v, sq=sq, sk=sk, sv=sv, mask=mask)
    sms = _sm_count(q.device)
    bm = default_row_tile(G, M, "inject", T, sms) if bm is None else bm
    prog = rkernel.program_tensors(inj, q.device)[0]
    plan = inject_launch_plan(G, M, D, T, P, bm, sms, prog.n_slots, prog.n_opbits,
                              prog.ops.shape[0])
    return attn_fused_inject_with_plan(inj, q, kt, v, sq, sk, sv, mask, scale=scale, plan=plan)


def attn_fused_inject_with_plan(inj: CompiledInjector, q, kt, v, sq, sk, sv, mask, *,
                                scale: float, plan: InjectPlan) -> torch.Tensor:
    """The inject kernel on checked CUDA operands under ``plan``: the
    wrapper passes ``inject_launch_plan``'s, the card tests others, so
    that every row tile and T split is held to the plain version."""
    G, M, D = q.shape
    T, P = kt.shape[-1], v.shape[-1]
    prog, ops, fin, vbits = rkernel.program_tensors(inj, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((G, M, P), dtype=torch.float32, device=q.device)
    state = _zeros(q.device, stream, plan.state_words, "attn_tsplit")
    scores = _score_scratch(q.device, stream, plan.score_words)
    INJECT(q.data_ptr(), kt.data_ptr(), v.data_ptr(), sq.data_ptr(), sk.data_ptr(),
           sv.data_ptr(), mask.data_ptr(), out.data_ptr(), state, scores, ops.data_ptr(),
           prog.ops.shape[0], fin.data_ptr(), vbits.data_ptr(), prog.n_opbits, prog.n_slots,
           prog.offset, scale, G, M, D, T, P, plan.bm, plan.slice_words, plan.qk_wpb,
           plan.qk_rpb, plan.pv_wpb, plan.pv_rpb, plan.items, int(plan.whole), stream)
    return out
