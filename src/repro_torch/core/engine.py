"""The injection half of the JAX package's ``core/engine.py``.

A ``reduction.Schedule`` is lowered once (``lower_schedule``, numpy, a copy
of the JAX package's lowering) into dense per-stage replay constants: PP
gate minterm masks, per-cell sum/carry minterm masks, wire routing and the
final bits' weights.  ``CompiledInjector`` replays those constants with
torch ops in **bit-sliced** form, every wire a 32-bit word whose bits are 32
independent operand pairs, and so computes the exact AMR-MUL product of any
int8 operand pair for ANY schedule, DSE candidates included, without a
256x256 table.  The replay is the plain version of the
``kernels/inject_replay`` CUDA kernel, which reads the same lowering.

Words are int32 tensors (torch has no general uint32 arithmetic): the bit
patterns are those of the JAX package's uint32 words, and ``>>`` followed
by ``& 1`` extracts a bit whatever the sign.

Not ported: ``CompiledSchedule``, ``evaluate_split_many``, the candidate
batch and the numpy lane packer that feeds them (the host-facing
Monte-Carlo engine).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from . import mrsd, ppgen, reduction
from .cells import CELLS

# Stable cell-type order; per-type truth tables are padded/tiled to 8 entries.
CELL_ORDER: tuple[str, ...] = tuple(sorted(CELLS))
_CELL_INDEX = {name: i for i, name in enumerate(CELL_ORDER)}

_LIMB_BITS = 16   # int32-safe: max limb weight 2**15, few hundred bits per limb
_LANE_BITS = 32   # operand pairs per 32-bit word


def _type_tables() -> tuple[np.ndarray, np.ndarray]:
    """(n_cell_types, 8) sum/carry truth tables over stored input bits."""
    sums = np.zeros((len(CELL_ORDER), 8), dtype=np.uint32)
    carries = np.zeros_like(sums)
    for name, t in _CELL_INDEX.items():
        cell = CELLS[name]
        s, c = np.asarray(cell.sum_table), np.asarray(cell.carry_table)
        if cell.n_in == 2:  # tile: the padded high input bit is a don't-care
            s, c = np.tile(s, 2), np.tile(c, 2)
        sums[t] = s
        carries[t] = c
    return sums, carries


# PP gate truth tables over (x, y), index x*2 + y (ppgen gate-type order).
_GATE_TABLES = np.array(
    [[0, 0, 0, 1],   # G_AND    x & y
     [1, 1, 0, 1],   # G_ORN_X  !x | y
     [1, 0, 1, 1],   # G_ORN_Y  !y | x
     [1, 0, 0, 0]],  # G_NOR
    dtype=np.uint32,
)

_FULL = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class StageTensors:
    """One reduction stage, densely packed (all cell groups concatenated)."""

    in3: np.ndarray        # (n_cells, 3) int32 wire ids; 2-in cells padded with 0
    sum_masks: np.ndarray  # (n_cells, 8) uint32 minterm masks (0 or all-ones)
    carry_masks: np.ndarray
    perm: np.ndarray       # (2 * n_cells,) int32: id-order slot -> concat slot


def _compile_stage(stage, stage_start: int) -> StageTensors:
    type_sum, type_carry = _type_tables()
    in3_rows: list[list[int]] = []
    cell_type: list[int] = []
    sum_ids: list[int] = []
    carry_ids: list[int] = []
    for g in stage:
        t = _CELL_INDEX[g.name]
        for row, sid, cid in zip(g.in_ids, g.sum_ids, g.carry_ids):
            ins = [int(b) for b in row]
            if len(ins) == 2:  # pad slot reads wire 0; tiled table ignores it
                ins = [0] + ins
            in3_rows.append(ins)
            cell_type.append(t)
            sum_ids.append(int(sid))
            carry_ids.append(int(cid))
    n_cells = len(in3_rows)
    # New wires of a stage are allocated contiguously during scheduling; the
    # permutation rebuilds allocation order from [all sums | all carries].
    if sorted(sum_ids + carry_ids) != list(range(stage_start, stage_start + 2 * n_cells)):
        raise AssertionError("stage outputs are not a contiguous wire-id block")
    perm = np.empty(2 * n_cells, dtype=np.int32)
    for k, (sid, cid) in enumerate(zip(sum_ids, carry_ids)):
        perm[sid - stage_start] = k
        perm[cid - stage_start] = n_cells + k
    t_idx = np.asarray(cell_type, dtype=np.int64)
    return StageTensors(
        in3=np.asarray(in3_rows, dtype=np.int32),
        sum_masks=(type_sum[t_idx] * _FULL).astype(np.uint32),
        carry_masks=(type_carry[t_idx] * _FULL).astype(np.uint32),
        perm=perm,
    )


def _i32(a: np.ndarray) -> np.ndarray:
    """uint32 words as int32 with the same bits."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: per-device caches key on it
class LoweredReplay:
    """A schedule's dense replay constants (numpy), shared by the torch
    replay below and the CUDA kernel's program (``kernels/inject_replay``).

    ``replay_stored`` works over ARBITRARY trailing batch dims: the wire axis
    is first, everything after broadcasts.
    """

    schedule: reduction.Schedule
    gate_masks: np.ndarray      # (n_pp, 4) uint32 full-word gate minterm masks
    x_idx: np.ndarray           # (n_pp,) int32 into flattened X operand bits
    y_idx: np.ndarray           # (n_pp,) int32 into flattened Y operand bits
    stages: tuple[StageTensors, ...]
    final_ids: np.ndarray       # (n_final,) int32 surviving wire ids
    weights: np.ndarray         # (n_final, n_limbs) int32 per-limb bit weights
    offsets: np.ndarray         # (n_limbs,) int32 polarity offsets per limb
    n_limbs: int
    bit_weights: np.ndarray     # (n_final,) int64: 2**pos, limb-combined
    offset_total: int           # limb-combined polarity offset

    def replay_stored(self, xw: torch.Tensor, yw: torch.Tensor) -> torch.Tensor:
        """Bit-sliced stage replay over broadcastable int32 wire words.

        ``xw``: (n_xbits, \\*dx) and ``yw``: (n_ybits, \\*dy) words with
        broadcast-compatible trailing dims; returns the stored final wire
        words ``(n_final, \\*broadcast(dx, dy))``.
        """
        c = _replay_consts(self, xw.device)
        extra = max(xw.dim(), yw.dim()) - 1

        def bc(m):  # lift a (n_rows,) constant over the trailing batch dims
            return m.reshape(m.shape[0], *(1,) * extra)

        x = xw[c["x_idx"]]
        y = yw[c["y_idx"]]
        nx, ny = ~x, ~y
        gm = c["gate_masks"]
        vals = ((bc(gm[:, 0]) & (nx & ny)) | (bc(gm[:, 1]) & (nx & y))
                | (bc(gm[:, 2]) & (x & ny)) | (bc(gm[:, 3]) & (x & y)))
        for in3, sm, cm, perm in c["stages"]:
            ins = vals[in3]  # (n_cells, 3, *batch)
            a, b, cc = ins[:, 0], ins[:, 1], ins[:, 2]
            na, nb, nc = ~a, ~b, ~cc
            minterms = (na & nb & nc, na & nb & cc, na & b & nc, na & b & cc,
                        a & nb & nc, a & nb & cc, a & b & nc, a & b & cc)
            s_out = bc(sm[:, 0]) & minterms[0]
            c_out = bc(cm[:, 0]) & minterms[0]
            for k in range(1, 8):
                s_out |= bc(sm[:, k]) & minterms[k]
                c_out |= bc(cm[:, k]) & minterms[k]
            vals = torch.cat([vals, torch.cat([s_out, c_out], 0)[perm]], 0)
        return vals[c["final_ids"]]


@lru_cache(maxsize=64)
def _replay_consts(lowered: LoweredReplay, device: torch.device) -> dict:
    """The lowering as torch tensors on ``device`` (words as int32)."""
    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return {
        "x_idx": t(lowered.x_idx), "y_idx": t(lowered.y_idx),
        "gate_masks": t(_i32(lowered.gate_masks), torch.int32),
        "stages": [(t(st.in3), t(_i32(st.sum_masks), torch.int32),
                    t(_i32(st.carry_masks), torch.int32), t(st.perm))
                   for st in lowered.stages],
        "final_ids": t(lowered.final_ids),
        "bit_weights": t(lowered.bit_weights),
    }


def lower_schedule(schedule: reduction.Schedule) -> LoweredReplay:
    """Lower a schedule to the dense numpy replay constants."""
    layout = schedule.layout
    stages = []
    n_wires = layout.n_pp
    for stage in schedule.stages:
        st = _compile_stage(stage, n_wires)
        stages.append(st)
        n_wires += st.perm.shape[0]
    if n_wires != schedule.n_bits:
        raise AssertionError("compiled wire count disagrees with schedule")

    pos = schedule.final_positions.astype(np.int64)
    pol = schedule.bit_polarity[schedule.final_ids].astype(np.int64)
    n_limbs = int(pos.max()) // _LIMB_BITS + 1
    # weights[i, l] = 2**(pos_i mod 16) when bit i lands in limb l, else 0
    weights_np = np.zeros((pos.shape[0], n_limbs), dtype=np.int32)
    weights_np[np.arange(pos.shape[0]), pos // _LIMB_BITS] = 1 << (pos % _LIMB_BITS)
    offsets_np = (pol[:, None] * weights_np).sum(0).astype(np.int32)
    bit_weights = np.int64(1) << pos
    return LoweredReplay(
        schedule=schedule,
        gate_masks=(_GATE_TABLES[layout.gate] * _FULL).astype(np.uint32),
        x_idx=layout.x_idx.astype(np.int32),
        y_idx=layout.y_idx.astype(np.int32),
        stages=tuple(stages),
        final_ids=schedule.final_ids.astype(np.int32),
        weights=weights_np,
        offsets=offsets_np,
        n_limbs=n_limbs,
        bit_weights=bit_weights,
        offset_total=int((pol * bit_weights).sum()),
    )


def _int8_value_bit_table(n_digits: int) -> np.ndarray:
    """(256, 5N) stored operand bits of every int8 value (index = v + 128).

    MRSD encoding is data-independent, so the 256 possible int8 operand
    values enumerate the whole bit-pattern domain of the injection path.
    """
    vals = np.arange(-128, 128, dtype=np.int64)
    return ppgen.flatten_operand_bits(mrsd.encode(vals, n_digits)).astype(np.uint32)


def _lanes_to_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) {0,1} int64 lanes -> (...) int32 words, lane l in bit l."""
    shifts = torch.arange(_LANE_BITS, device=bits.device)
    words = (bits << shifts).sum(-1)           # disjoint bits: the sum is the OR
    return (words - ((words >> 31) << 32)).to(torch.int32)  # two's-complement view


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: per-device caches key on it
class CompiledInjector:
    """A schedule lowered to a per-pair product evaluator over int8 operands.

    Operand *indices* (value + 128) select stored bits from the constant
    value->bits table; the replay runs bit-sliced with torch ops on the
    operands' device.  ``compile_injector`` rejects schedules whose dynamic
    range does not fit int32 (n_digits <= 3 in practice).
    """

    schedule: reduction.Schedule
    lowered: LoweredReplay
    value_bits: np.ndarray       # (256, n_opbits) uint32 {0, 1}
    max_abs_product: int = 0     # exact max |product| (int32 saturation checks)

    @property
    def n_opbits(self) -> int:
        return int(self.value_bits.shape[1])

    def value_bits_tensor(self, device: torch.device) -> torch.Tensor:
        """(256, n_opbits) int64 {0, 1} on ``device``."""
        return _value_bits(self.schedule.n_digits, torch.device(device))

    def products(self, ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
        """Exact AMR products of int8 operand indices: equal-shape int
        tensors in [0, 256) -> int32 products of the same shape."""
        if ia.shape != ib.shape:
            raise ValueError(f"operand index shapes differ: {tuple(ia.shape)} vs "
                             f"{tuple(ib.shape)}")
        vb = self.value_bits_tensor(ia.device)
        n = ia.numel()
        pad = (-n) % _LANE_BITS

        def words(idx):  # (n,) -> (n_opbits, n_words)
            bits = vb[torch.nn.functional.pad(idx.reshape(-1).long(), (0, pad))]
            return _lanes_to_words(bits.reshape(-1, _LANE_BITS, self.n_opbits).transpose(1, 2)).T

        stored = self.lowered.replay_stored(words(ia), words(ib))   # (n_final, n_words)
        return self._unpack(stored).reshape(-1)[:n].reshape(ia.shape)

    def operand_masks(self, ia: torch.Tensor) -> torch.Tensor:
        """Operand indices (...) -> (..., n_opbits) int32 full-word masks
        (each stored bit becomes 0 or all ones)."""
        return -self.value_bits_tensor(ia.device)[ia.long()].to(torch.int32)

    def pack_weights(self, ib: torch.Tensor) -> torch.Tensor:
        """(K, N) operand indices -> (K, n_opbits, n_words) int32 lane words.

        Column ``n`` lives in bit ``n % 32`` of word ``n // 32``.  N is
        padded to whole words with index 128 (value 0): padded products stay
        bounded by ``max_abs_product``, and callers slice the first N
        columns.
        """
        pad = (-ib.shape[1]) % _LANE_BITS
        ib = torch.nn.functional.pad(ib.long(), (0, pad), value=128)
        k, n = ib.shape
        bits = self.value_bits_tensor(ib.device)[ib]                # (K, N, nb)
        lanes = bits.reshape(k, n // _LANE_BITS, _LANE_BITS, -1).transpose(2, 3)
        return _lanes_to_words(lanes).transpose(1, 2).contiguous()  # (K, nb, W)

    def products_outer(self, xm: torch.Tensor, yw: torch.Tensor) -> torch.Tensor:
        """Exact products of every (row, column) pair.

        ``xm``: (R, C, n_opbits) operand masks, ``yw``: (C, n_opbits, W)
        packed words -> (R, C, W*32) int32, entry (r, c, w*32+l) the product
        of x operand (r, c) and the y operand in lane l of word w.
        """
        r, c, _ = xm.shape
        w = yw.shape[-1]
        x = xm.permute(2, 0, 1)[:, :, :, None]      # (n_opbits, R, C, 1)
        y = yw.permute(1, 0, 2)[:, None, :, :]      # (n_opbits, 1, C, W)
        stored = self.lowered.replay_stored(x, y)   # (n_final, R, C, W)
        return self._unpack(stored).reshape(r, c, w * _LANE_BITS)

    def _unpack(self, stored: torch.Tensor) -> torch.Tensor:
        """(n_final, \\*batch) words -> (\\*batch, 32) int32 products:
        sum_f 2**pos_f * bit_f - offset, accumulated per final bit."""
        shifts = torch.arange(_LANE_BITS, device=stored.device, dtype=torch.int32)
        bw = _replay_consts(self.lowered, stored.device)["bit_weights"].to(torch.int32)
        acc = torch.zeros((*stored.shape[1:], _LANE_BITS), dtype=torch.int32,
                          device=stored.device)
        for f in range(stored.shape[0]):
            acc += bw[f] * ((stored[f][..., None] >> shifts) & 1)
        return acc - self.lowered.offset_total


@lru_cache(maxsize=16)
def _value_bits(n_digits: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_int8_value_bit_table(n_digits).astype(np.int64)).to(device)


def compile_injector(schedule: reduction.Schedule) -> CompiledInjector:
    """Lower a schedule to the injection evaluator.

    Raises ``ValueError`` when the schedule's output dynamic range exceeds
    int32; every 2-digit (int8-operand) schedule is comfortably inside.
    ``max_abs_product`` is exact, from one replay of all 65,536 int8 pairs.
    """
    lowered = lower_schedule(schedule)
    bound = int(lowered.bit_weights.sum())  # >= max |value| + |offset|
    if 2 * bound >= 2**31:
        raise ValueError(
            f"schedule dynamic range (sum 2**pos = {bound}) exceeds int32; "
            f"on-device injection supports n_digits <= 3 "
            f"(got n_digits={schedule.n_digits})")
    inj = CompiledInjector(schedule=schedule, lowered=lowered,
                           value_bits=_int8_value_bit_table(schedule.n_digits))
    pairs = torch.arange(256 * 256)
    prods = inj.products(pairs // 256, pairs % 256)
    return dataclasses.replace(inj, max_abs_product=int(prods.abs().max()))


@lru_cache(maxsize=64)
def get_injector(n_digits: int, border: int | None) -> CompiledInjector:
    """Process-level injector cache for the default design points."""
    return compile_injector(reduction.get_schedule(n_digits, border))
