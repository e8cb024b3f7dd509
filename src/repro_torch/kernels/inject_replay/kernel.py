"""Wrapper of the hand-written circuit-replay kernel (``csrc/inject_replay.cu``,
whose device code is ``csrc/replay_device.cuh``).

``inject_replay_int32`` replaces the JAX package's Pallas kernel
``kernels/inject_replay/kernel.py::_replay_block``: exact AMR-MUL products
of int8 operand indices (value + 128), summed over K in int32, for any
``reduction.Schedule``.

The kernel reads the schedule as data.  ``replay_program`` lowers an
injector's ``LoweredReplay`` into the kernel's tables (ops, wire slots,
final-bit slots, value bits), and ``program_tensors`` keeps them on each
device, so one build of the kernel serves every schedule.  The build
compiles ``CELL_PAIRS`` (the (sum, carry) truth tables of ``core/cells.py``
under each order of their inputs) as LOP3 immediates; the program groups
its cells into runs of one pair, named by index into that list, and a
pair outside it (``ReplayProgram.generic_ops`` counts such cells) runs in
the kernel's minterm form.

A tensor's device decides the route: CPU tensors go to the plain version
(``ref.replay_matmul_ref``); CUDA tensors go to the kernel, which raises on
what it does not take.  The wrapper checks device, dtype, shape and
contiguity, allocates the zero-filled output (split-K partial sums meet in
atomics), launches on PyTorch's current stream and counts the launch on
``REPLAY``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
import itertools
import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.cells import CELLS
from repro_torch.core.engine import CompiledInjector, LoweredReplay

from ..build import CudaKernel, CudaLibrary
from .ref import replay_matmul_ref


def _gate_byte(gm) -> int:
    """A PP gate's table over (x, y) as a LOP3 byte over (x, y, y)."""
    return sum(1 << i for i in range(8) if gm[(i >> 2) * 2 + ((i >> 1) & 1)])


def _permuted(table, order) -> int:
    """The LOP3 byte of a 3-input table with its inputs taken in ``order``."""
    byte = 0
    for i in range(8):
        bits = ((i >> 2) & 1, (i >> 1) & 1, i & 1)
        if table[bits[order[0]] * 4 + bits[order[1]] * 2 + bits[order[2]]]:
            byte |= 1 << i
    return byte


def cell_pairs() -> tuple[tuple[int, int], ...]:
    """The (sum, carry) truth-table pairs the kernel compiles as LOP3
    immediates, ascending: every cell of ``core/cells.py`` (a 2-input
    cell's tables tiled over its unused first input, as the lowering pads
    it) under each order of its three inputs.  A lowering that drops an
    input neither table reads keeps the tables' bytes, so those are in."""
    found = set()
    for cell in CELLS.values():
        tables = [list(t) * (2 if cell.n_in == 2 else 1) for t in (cell.sum_table,
                                                                   cell.carry_table)]
        for order in itertools.permutations(range(3)):
            found.add(tuple(_permuted(t, order) for t in tables))
    return tuple(sorted(found))


CELL_PAIRS = cell_pairs()
GENERIC = 0xFFFF  # kGeneric in replay_device.cuh: the run case of a pair outside CELL_PAIRS
_MAX_PAIRS = 32   # kMaxPairs: the cases of the kernel's pair switch
_PAIR_INDEX = {pair: i for i, pair in enumerate(CELL_PAIRS)}
if len(CELL_PAIRS) > _MAX_PAIRS or (0, 0) in _PAIR_INDEX:
    raise AssertionError(f"the kernel compiles up to {_MAX_PAIRS} nonzero cell pairs, the cells "
                         f"give {CELL_PAIRS}")
# the list as 16-bit entries (sum << 8 | carry), four to a definition: nvcc splits a
# definition's value at commas, so the list cannot go as one
DEFINES = tuple(
    f"REPLAY_CELL_PAIRS{w}=0x"
    + "".join(f"{s << 8 | c:04x}" for s, c in reversed(CELL_PAIRS[4 * w:4 * w + 4])).rjust(16, "0")
    + "ULL" for w in range(_MAX_PAIRS // 4))

_CSRC = Path(__file__).resolve().parent / "csrc"
DEVICE_HEADER = _CSRC / "replay_device.cuh"  # the replay's device code, shared with attn_fused
LIBRARY = CudaLibrary(_CSRC / "inject_replay.cu", (DEVICE_HEADER,), DEFINES)
LIBRARIES = (LIBRARY,)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
REPLAY = CudaKernel("inject_replay", LIBRARY, "inject_replay_matmul",
                    [_P, _P, _L, _P, _P, _I, _P, _P] + [_I] * 11 + [_P])
KERNELS = (REPLAY,)

THREADS = 128     # kThreads in inject_replay.cu
ITEMS = 3         # kItems: k values a thread replays in lockstep (or 1, launch_shape)
POSITIONS = 24    # kPos: final-bit positions the kernel reads
MIN_SLOTS = 32    # the kernel reuses the slots for its 32-lane reduction


@dataclasses.dataclass(frozen=True)
class ReplayProgram:
    """The kernel's view of one schedule (see ``csrc/replay_device.cuh``).

    ``ops`` is a sequence of runs, each a header record ``(count | 2 << 24,
    case)`` and ``count`` op records ``(a | b << 8 | c << 16 | kind << 24,
    out0 | out1 << 8 | tt0 << 16 | tt1 << 24)``: kind 0 is a PP gate (a = x
    bit, b = y bit, tt0 over (x, y, y)), kind 1 a cell (a, b, c input slots,
    out0/out1 the sum and carry slots, tt0/tt1 their truth tables).  A truth
    table's bit ``a*4 + b*2 + c`` is f(a, b, c), the LOP3 convention.  Every
    cell of a run has the (sum, carry) pair ``CELL_PAIRS[case]``, or its
    own bytes when the case is ``GENERIC``; gates may sit in any run.
    """

    ops: np.ndarray         # (n_records, 2) uint32: run headers and ops
    fin: np.ndarray         # (POSITIONS, 2) uint32: slots of the final bits by position
    value_bits: np.ndarray  # (256,) uint32: stored bits of each operand index
    n_slots: int
    n_opbits: int
    offset: int             # polarity offset subtracted from every product
    n_ops: int              # gates and cells (records less run headers)
    n_runs: int
    generic_ops: int        # cells whose pair is outside CELL_PAIRS


def _truth_byte(masks: np.ndarray) -> int:
    return sum(1 << k for k in range(8) if masks[k])


def replay_program(lowered: LoweredReplay, value_bits: np.ndarray) -> ReplayProgram:
    """Lower a replay to the kernel's program, without changing the circuit.

    Cells run in stage order, and within a stage (whose cells are
    independent) grouped by their (sum, carry) pair, so the program is a
    few runs of one pair each (about 20 at the paper's schedules); each PP
    gate is emitted just before its first reader, and a wire's slot is
    freed after its last reader, so about 65 slots hold a 302-wire
    schedule.  Every wire is read by at most one cell (a Wallace stage
    consumes each bit once), which the lowering is checked for; an input
    that neither truth table depends on (the pad of a 2-input cell) is not
    read.
    """
    n_pp = lowered.x_idx.shape[0]
    cells = []  # (inputs, (sum wire, carry wire), (sum tt, carry tt))
    wire = n_pp
    for st in lowered.stages:
        n = st.in3.shape[0]
        ids = np.empty(2 * n, dtype=np.int64)
        ids[st.perm] = wire + np.arange(2 * n)   # concat slot -> wire id
        for c in range(n):
            tts = (_truth_byte(st.sum_masks[c]), _truth_byte(st.carry_masks[c]))
            ins = [int(w) for w in st.in3[c]]
            for pos, bit in ((0, 4), (1, 2), (2, 1)):  # drop inputs no table reads
                if all(((tt >> k) & 1) == ((tt >> (k ^ bit)) & 1) for tt in tts
                       for k in range(8)):
                    ins[pos] = None
            cells.append((ins, (int(ids[c]), int(ids[n + c])), tts))
        first = len(cells) - n  # the stage's cells, grouped by pair (stable)
        cells[first:] = sorted(cells[first:], key=lambda cl: _PAIR_INDEX.get(cl[2], GENERIC))
        wire += 2 * n

    final = [int(f) for f in lowered.final_ids]
    readers: dict[int, int] = {}
    for i, (ins, _, _) in enumerate(cells):
        for w in ins:
            if w is not None:
                if w in readers or w in final:
                    raise ValueError(f"wire {w} has more than one reader; the replay "
                                     f"program assumes a Wallace schedule")
                readers[w] = i

    free = list(range(1, 256))  # slot 0 is the constant zero word
    slot: dict[int, int] = {}
    runs: list[list] = []       # [case, op records]; case None until a cell sets it

    def take(w: int) -> int:
        slot[w] = heapq.heappop(free)
        return slot[w]

    def gate(w: int) -> None:
        tt = _gate_byte(lowered.gate_masks[w])
        if not runs:
            runs.append([None, []])
        runs[-1][1].append((int(lowered.x_idx[w]) | int(lowered.y_idx[w]) << 8,
                            take(w) | tt << 16))

    for ins, (ws, wc), (tts, ttc) in cells:
        live = [w for w in ins if w is not None]
        for w in live:
            if w < n_pp and w not in slot:
                gate(w)
        a, b, c = (slot[w] if w is not None else slot[live[0]] for w in ins)
        for w in live:
            heapq.heappush(free, slot[w])
        s0, s1 = take(ws), take(wc)
        case = _PAIR_INDEX.get((tts, ttc), GENERIC)
        if not runs or runs[-1][0] not in (None, case):
            runs.append([case, []])
        runs[-1][0] = case
        runs[-1][1].append((a | b << 8 | c << 16 | 1 << 24,
                            s0 | s1 << 8 | tts << 16 | ttc << 24))
        for w in (ws, wc):
            if w not in readers and w not in final:
                heapq.heappush(free, slot[w])
    for w in final:
        if w < n_pp and w not in slot:
            gate(w)

    fin = np.zeros((POSITIONS, 2), dtype=np.uint32)
    used = np.zeros(POSITIONS, dtype=np.int64)
    for w, bw in zip(final, lowered.bit_weights):
        pos = int(bw).bit_length() - 1
        if pos >= POSITIONS or used[pos] == 2:
            raise ValueError(f"final bits at position {pos}: the kernel reads two per "
                             f"position below {POSITIONS}")
        fin[pos, used[pos]] = slot[w]
        used[pos] += 1
    n_slots = max(max(slot.values()) + 1, MIN_SLOTS)
    vb = (value_bits.astype(np.uint32) << np.arange(value_bits.shape[1], dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)
    records = []
    for case, run in runs:
        records.append((len(run) | 2 << 24, 0 if case is None else case))
        records += run
    return ReplayProgram(
        ops=np.asarray(records, dtype=np.uint32), fin=fin, value_bits=vb, n_slots=n_slots,
        n_opbits=int(value_bits.shape[1]), offset=int(lowered.offset_total),
        n_ops=sum(len(run) for _, run in runs), n_runs=len(runs),
        generic_ops=sum(op[0] >> 24 == 1 for case, run in runs if case == GENERIC for op in run))


@lru_cache(maxsize=64)
def program_tensors(inj: CompiledInjector, device: torch.device):
    """(program, ops, fin, value_bits) for ``inj``, the tables on ``device``."""
    prog = replay_program(inj.lowered, inj.value_bits)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    return prog, t(prog.ops), t(prog.fin), t(prog.value_bits)


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 operand indices, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_shape(M: int, n_words: int) -> tuple[int, int, int]:
    """(wpb, rpb, kpb): words, rows and k-lanes of a 128-thread block.

    Words first (up to 64), then rows (up to 16), the rest of the block
    splits K, so a one-word grouped QK^T and a two-row decode both fill it.
    """
    wpb = min(64, 1 << max(0, math.ceil(math.log2(n_words))))
    rpb = min(16, THREADS // wpb, 1 << max(0, math.ceil(math.log2(M))))
    return wpb, rpb, THREADS // (wpb * rpb)


def replay_block(M: int, N: int) -> tuple[int, int]:
    """(wpb, rpb): words and rows of a 128-thread block, rows first (up to
    16: the block packs B once for all its rows), then words."""
    rpb = min(16, 1 << max(0, math.ceil(math.log2(M))))
    return min(THREADS // rpb, 1 << max(0, math.ceil(math.log2(math.ceil(N / 32))))), rpb


@lru_cache(maxsize=256)
def launch_shape(G: int, M: int, N: int, K: int, sms: int,
                 per_sm: tuple[int, int]) -> tuple[int, int, int, int]:
    """(wpb, rpb, k_chunk, items) of a launch: the block shape
    (``replay_block``), the K per block and the k values a thread replays
    at once.  ``per_sm`` holds the blocks one SM holds with ITEMS
    and with 1 item a thread (``blocks_per_sm``; 0 where a block does not
    fit).

    K is split until the blocks fill one wave of per_sm blocks per SM (a
    second, partial wave would double the time), keeping at least one step
    (kpb x items k) per block.  Where ITEMS items a thread run out of K
    steps before the grid holds a block per SM, or do not fit, a thread
    takes 1.  The atomics that join the splits are exact in any order, so
    neither choice changes a bit.
    """
    wpb, rpb = replay_block(M, N)
    kpb = THREADS // (wpb * rpb)
    blocks = G * math.ceil(math.ceil(N / 32) / wpb) * math.ceil(M / rpb)
    if per_sm[1] < 1:
        raise ValueError(f"no block of the replay kernel fits on an SM ({per_sm})")
    for items, fit in zip((ITEMS, 1), per_sm):
        if fit < 1:
            continue
        wave = max(1, fit * sms // blocks)
        splits = min(wave, max(1, math.ceil(K / (kpb * items))))
        if splits == wave or blocks * splits >= sms:
            break
    return wpb, rpb, math.ceil(K / splits), items


def blocks_per_sm(items: int, prog: ReplayProgram, wpb: int, rpb: int) -> int:
    """Blocks of the kernel with ``items`` k values a thread that one SM of
    the current CUDA device holds, at ``prog``'s shared memory (0 where
    one block's exceeds the limit): the driver's occupancy calculation."""
    fn = LIBRARY.handle().inject_replay_blocks_per_sm
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(items, prog.ops.shape[0], prog.n_slots, prog.n_opbits, wpb, rpb,
             ctypes.byref(blocks))
    if err != 0:
        msg = LIBRARY.handle().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"inject_replay_blocks_per_sm: CUDA error {err} ({msg})")
    return blocks.value


@lru_cache(maxsize=256)
def launch_plan(inj: CompiledInjector, device: torch.device, G: int, M: int, N: int, K: int,
                grouped: bool) -> tuple[tuple, tuple]:
    """(tensors, args) of a launch: the program tensors on ``device``, kept
    alive here, and the kernel's arguments from ``out`` on (C order),
    pointers into them included, so that a call of a seen shape only looks
    the launch up.  Its last four ints are k_chunk, wpb, rpb and items."""
    prog, ops, fin, vbits = program_tensors(inj, device)
    wpb, rpb = replay_block(M, N)
    with torch.cuda.device(device):
        per_sm = tuple(blocks_per_sm(items, prog, wpb, rpb) for items in (ITEMS, 1))
    _, _, k_chunk, items = launch_shape(G, M, N, K, _sm_count(device), per_sm)
    return (ops, fin, vbits), (K * N if grouped else 0, ops.data_ptr(), prog.ops.shape[0],
                               fin.data_ptr(), vbits.data_ptr(), prog.n_opbits, prog.n_slots,
                               prog.offset, G, M, N, K, k_chunk, wpb, rpb, items)


def inject_replay_int32(inj: CompiledInjector, ia: torch.Tensor,
                        ib: torch.Tensor) -> torch.Tensor:
    """ia (G, M, K), ib (K, N) or (G, K, N) int32 operand indices in
    [0, 256) -> int32 (G, M, N), ``out[g, m, n] = sum_k AMR(ia[g, m, k],
    ib[g, k, n])`` under ``inj``'s schedule.

    The caller bounds K * max|product| below 2**31.
    """
    _check("ia", ia, 3)
    if ib.dim() not in (2, 3):
        raise ValueError(f"ib must be (K, N) or (G, K, N), got shape {tuple(ib.shape)}")
    _check("ib", ib, ib.dim())
    G, M, K = ia.shape
    if ib.shape[-2] != K or (ib.dim() == 3 and ib.shape[0] != G):
        raise ValueError(f"shapes mismatch: ia {tuple(ia.shape)} @ ib {tuple(ib.shape)}")
    N = ib.shape[-1]
    if ia.device != ib.device:
        raise ValueError(f"operands on different devices: {ia.device}, {ib.device}")
    if ia.device.type == "cpu":
        return replay_matmul_ref(inj, ia, ib)
    if ia.device.type != "cuda":
        raise ValueError(f"the replay kernel takes CPU or CUDA tensors, got {ia.device}")
    if not (ia.is_contiguous() and ib.is_contiguous()):
        raise ValueError("ia and ib must be contiguous for the CUDA kernel")
    _, (stride, *args) = launch_plan(inj, ia.device, G, M, N, K, ib.dim() == 3)
    out = torch.zeros((G, M, N), dtype=torch.int32, device=ia.device)
    REPLAY(ia.data_ptr(), ib.data_ptr(), stride, out.data_ptr(), *args,
           torch.cuda.current_stream(ia.device).cuda_stream)
    return out
