"""Wrapper of the hand-written circuit-replay kernel (``csrc/inject_replay.cu``,
whose device code is ``csrc/replay_device.cuh``).

``inject_replay_int32`` replaces the JAX package's Pallas kernel
``kernels/inject_replay/kernel.py::_replay_block``: exact AMR-MUL products
of int8 operand indices (value + 128), summed over K in int32, for any
``reduction.Schedule``.

The kernel reads the schedule as data.  ``replay_program`` lowers an
injector's ``LoweredReplay`` into the kernel's tables (ops, wire slots,
final-bit slots, value bits), and ``program_tensors`` keeps them on each
device, so one build of the kernel serves every schedule.

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
import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.engine import CompiledInjector, LoweredReplay

from ..build import CudaKernel, CudaLibrary
from .ref import replay_matmul_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
DEVICE_HEADER = _CSRC / "replay_device.cuh"  # the replay's device code, shared with attn_fused
LIBRARY = CudaLibrary(_CSRC / "inject_replay.cu", (DEVICE_HEADER,))
LIBRARIES = (LIBRARY,)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
REPLAY = CudaKernel("inject_replay", LIBRARY, "inject_replay_matmul",
                    [_P, _P, _L, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P])
KERNELS = (REPLAY,)

THREADS = 128     # kThreads in inject_replay.cu
POSITIONS = 24    # kPos: final-bit positions the kernel reads
MIN_SLOTS = 32    # the kernel reuses the slots for its 32-lane reduction
_MIN_K_PER_THREAD = 1
_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class ReplayProgram:
    """The kernel's view of one schedule (see ``csrc/inject_replay.cu``).

    ``ops`` rows are ``(a | b << 8 | c << 16 | kind << 24,
    out0 | out1 << 8 | tt0 << 16 | tt1 << 24)``: kind 0 is a PP gate (a = x
    bit, b = y bit, tt0 over (x, y, y)), kind 1 a cell (a, b, c input slots,
    out0/out1 the sum and carry slots, tt0/tt1 their truth tables).  A truth
    table's bit ``a*4 + b*2 + c`` is f(a, b, c), the LOP3 convention.
    """

    ops: np.ndarray         # (n_ops, 2) uint32
    fin: np.ndarray         # (POSITIONS, 2) uint32: slots of the final bits by position
    value_bits: np.ndarray  # (256,) uint32: stored bits of each operand index
    n_slots: int
    n_opbits: int
    offset: int             # polarity offset subtracted from every product


def _truth_byte(masks: np.ndarray) -> int:
    return sum(1 << k for k in range(8) if masks[k])


def replay_program(lowered: LoweredReplay, value_bits: np.ndarray) -> ReplayProgram:
    """Lower a replay to the kernel's program, without changing the circuit.

    Cells run in stage order; each PP gate is emitted just before its first
    reader, and a wire's slot is freed after its last reader, so about 65
    slots hold a 302-wire schedule.  Every wire is read by at most one cell
    (a Wallace stage consumes each bit once), which the lowering is checked
    for; an input that neither truth table depends on (the pad of a 2-input
    cell) is not read.
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
    ops: list[tuple[int, int]] = []

    def take(w: int) -> int:
        slot[w] = heapq.heappop(free)
        return slot[w]

    def gate(w: int) -> None:
        gm = lowered.gate_masks[w]
        tt = sum(1 << i for i in range(8) if gm[(i >> 2) * 2 + ((i >> 1) & 1)])
        ops.append((int(lowered.x_idx[w]) | int(lowered.y_idx[w]) << 8,
                    take(w) | tt << 16))

    for i, (ins, (ws, wc), (tts, ttc)) in enumerate(cells):
        live = [w for w in ins if w is not None]
        for w in live:
            if w < n_pp and w not in slot:
                gate(w)
        a, b, c = (slot[w] if w is not None else slot[live[0]] for w in ins)
        for w in live:
            heapq.heappush(free, slot[w])
        s0, s1 = take(ws), take(wc)
        ops.append((a | b << 8 | c << 16 | 1 << 24, s0 | s1 << 8 | tts << 16 | ttc << 24))
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
    return ReplayProgram(ops=np.asarray(ops, dtype=np.uint32), fin=fin, value_bits=vb,
                         n_slots=n_slots, n_opbits=int(value_bits.shape[1]),
                         offset=int(lowered.offset_total))


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


def _k_chunk(blocks: int, K: int, kpb: int, device: torch.device) -> int:
    """K per block: split K until about _BLOCKS_PER_SM blocks per SM are in
    flight, keeping at least _MIN_K_PER_THREAD k per thread.  The atomics
    that join the splits are exact in any order, so the split never changes
    a bit."""
    splits = min(max(1, math.ceil(_BLOCKS_PER_SM * _sm_count(device) / blocks)),
                 max(1, math.ceil(K / (kpb * _MIN_K_PER_THREAD))))
    return math.ceil(K / splits)


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
    prog, ops, fin, vbits = program_tensors(inj, ia.device)
    n_words = math.ceil(N / 32)
    wpb, rpb, kpb = block_shape(M, n_words)
    blocks = G * math.ceil(n_words / wpb) * math.ceil(M / rpb)
    out = torch.zeros((G, M, N), dtype=torch.int32, device=ia.device)
    REPLAY(ia.data_ptr(), ib.data_ptr(), K * N if ib.dim() == 3 else 0, out.data_ptr(),
           ops.data_ptr(), prog.ops.shape[0], fin.data_ptr(), vbits.data_ptr(), prog.n_opbits,
           prog.n_slots, prog.offset, G, M, N, K, _k_chunk(blocks, K, kpb, ia.device), wpb, rpb,
           ctypes.c_void_p(torch.cuda.current_stream(ia.device).cuda_stream))
    return out
