"""The JAX package's ``core/engine.py`` in torch: the schedule replay.

A ``reduction.Schedule`` is lowered once (``lower_schedule``, numpy, a copy
of the JAX package's lowering) into dense per-stage replay constants: PP
gate minterm masks, per-cell sum/carry minterm masks, wire routing and the
final bits' weights.  ``LoweredReplay.replay_stored`` replays them with
torch ops in **bit-sliced** form, every wire a 32-bit word whose bits are 32
independent operand pairs.  Two callers share that one replay:

* the host-facing engine (``CompiledSchedule``, ``get_engine``,
  ``evaluate_split_many``, ``CandidateBatch``): stored operand bits from
  numpy are packed into lanes on the host (``_pack_lanes``) and moved to
  the engine's device once; each schedule's replay then runs on them in
  turn (the JAX package's "one fused XLA dispatch").  The final bits are
  summed into 16-bit position limbs by a float64 product on the device
  (exact: the weights are powers of two below 2**16, the bits 0 or 1, a
  limb's sum far below 2**53; torch has no integer matmul on CUDA), and
  the limbs are combined on the host into the exact ``(lo, hi)`` int64
  split (value = lo + hi * 2**32) of ``reduction.evaluate_split``, bit for
  bit.  The device is explicit, ``"cuda"`` by default
  (``device.resolve_device`` raises without a card);
* ``CompiledInjector``: the exact AMR-MUL product of any int8 operand pair
  for ANY schedule, DSE candidates included, without a 256x256 table.  Its
  replay is the plain version of the ``kernels/inject_replay`` CUDA
  kernel, which reads the same lowering.

Words are int32 tensors (torch has no general uint32 arithmetic): the bit
patterns are those of the JAX package's uint32 words, and ``>>`` followed
by ``& 1`` extracts a bit whatever the sign.
"""
from __future__ import annotations

import dataclasses
import sys
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
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
        "limb_weights": t(lowered.weights.T, torch.float64),   # (n_limbs, n_final)
        "offsets": t(lowered.offsets),
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


# --------------------------------------------------------------------------
# The host-facing engine: numpy operand bits in, exact (lo, hi) splits out
# --------------------------------------------------------------------------

def _pack_lanes(bits: np.ndarray) -> np.ndarray:
    """(batch, n_bits) {0,1} -> bit-sliced (n_bits, words) uint32.

    Sample ``w * 32 + k`` lives in bit ``k`` of word ``w`` of each wire row.
    The batch is zero-padded up to a whole number of 32-sample words.
    """
    bits = np.ascontiguousarray(bits.T, dtype=np.uint8)
    pad = (-bits.shape[1]) % _LANE_BITS
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    if sys.byteorder == "little":
        packed = np.packbits(bits, axis=1, bitorder="little")
        return np.ascontiguousarray(packed).view(np.uint32)
    words = np.zeros((bits.shape[0], bits.shape[1] // _LANE_BITS), dtype=np.uint32)
    for k in range(_LANE_BITS):  # big-endian fallback: explicit lane packing
        words |= bits[:, k::_LANE_BITS].astype(np.uint32) << np.uint32(k)
    return words


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledSchedule:
    """A design point lowered to dense tensors, replayed on ``device``.

    ``evaluate_split`` is bit-exact against ``reduction.evaluate_split``
    (held by tests/test_torch_core_engine.py across design points).
    """

    lowered: LoweredReplay
    device: torch.device

    @property
    def schedule(self) -> reduction.Schedule:
        return self.lowered.schedule

    @property
    def n_limbs(self) -> int:
        return self.lowered.n_limbs

    def limbs(self, xw: torch.Tensor, yw: torch.Tensor) -> torch.Tensor:
        """(n_opbits, words) int32 lane words -> (n_limbs, words * 32) int64
        limbs on the words' device, the polarity offsets taken off."""
        stored = self.lowered.replay_stored(xw, yw)              # (n_final, words)
        c = _replay_consts(self.lowered, stored.device)
        shifts = torch.arange(_LANE_BITS, device=stored.device, dtype=torch.int32)
        bits = ((stored[:, :, None] >> shifts) & 1).to(torch.float64)
        limbs = c["limb_weights"] @ bits.reshape(bits.shape[0], -1)  # exact in float64
        return limbs.to(torch.int64) - c["offsets"][:, None]

    def evaluate_split(
        self, xbits: np.ndarray, ybits: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(batch, 5N) stored operand bits -> exact (lo, hi) int64 split."""
        return _evaluate((self,), xbits, ybits)[0]

    def evaluate(self, xbits: np.ndarray, ybits: np.ndarray) -> np.ndarray:
        """Float64 result value (exact only below ~2**53, as the numpy path)."""
        return reduction.split_to_float(*self.evaluate_split(xbits, ybits))


def compile_schedule(schedule: reduction.Schedule,
                     device: str | torch.device = "cuda") -> CompiledSchedule:
    """Lower a schedule to dense tensors, replayed on ``device``."""
    return CompiledSchedule(lower_schedule(schedule), resolve_device(device))


def _combine_limbs(limbs: np.ndarray, n_limbs: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_limbs, padded_batch) integer limbs -> exact (lo, hi) int64 split."""
    limbs = limbs.astype(np.int64)[:, :batch]
    lo = limbs[0].copy()
    if n_limbs > 1:
        lo += limbs[1] * (1 << _LIMB_BITS)
    hi = np.zeros_like(lo)
    for limb in range(2, n_limbs):
        hi += limbs[limb] * (1 << (_LIMB_BITS * (limb - 2)))
    return lo, hi


def _evaluate(engines, xbits: np.ndarray, ybits: np.ndarray) -> list:
    """Pack and move a shared operand batch once, replay every engine on it
    in turn, then read every engine's limbs back: [(lo, hi), ...]."""
    xw, yw = (torch.from_numpy(_i32(_pack_lanes(b))).to(engines[0].device)
              for b in (xbits, ybits))
    outs = [e.limbs(xw, yw) for e in engines]
    return [_combine_limbs(limbs.cpu().numpy(), e.n_limbs, xbits.shape[0])
            for e, limbs in zip(engines, outs)]


def get_engine(n_digits: int, border: int | None,
               device: str | torch.device = "cuda") -> CompiledSchedule:
    """Process-level compiled-artifact cache, keyed on the design point and
    the device."""
    return _get_engine(n_digits, border, resolve_device(device))


@lru_cache(maxsize=64)
def _get_engine(n_digits: int, border: int | None, device: torch.device) -> CompiledSchedule:
    return compile_schedule(reduction.get_schedule(n_digits, border), device)


def evaluate_split_many(
    n_digits: int, borders: tuple, xbits: np.ndarray, ybits: np.ndarray,
    device: str | torch.device = "cuda",
) -> dict:
    """Several approximate borders on one shared batch.

    The operand batch is bit-sliced into lanes and moved to the device ONCE;
    every border's cached replay then runs on it in turn.  Returns
    ``{border: (lo, hi)}`` with the same exact int64 split as
    ``CompiledSchedule.evaluate_split``.
    """
    borders = tuple(borders)
    engines = tuple(get_engine(n_digits, b, device) for b in borders)
    return dict(zip(borders, _evaluate(engines, xbits, ybits)))


@dataclasses.dataclass(frozen=True)
class CandidateBatch:
    """Several candidate schedules evaluated on one shared operand batch.

    The cached ``evaluate_split_many`` path is keyed on ``(n_digits,
    border)`` design points; DSE exploration instead produces *ad-hoc*
    schedules (alternative cell assignments for the same design point) that
    have no cache key.  ``compile_candidates`` lowers each one once, so a
    Monte-Carlo sweep over many frontier candidates packs and moves each
    operand chunk once for all of them.  Reuse one ``CandidateBatch``
    across chunks.
    """

    engines: tuple[CompiledSchedule, ...]

    def evaluate_split(
        self, xbits: np.ndarray, ybits: np.ndarray
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Shared operand batch -> per-candidate exact (lo, hi) splits."""
        return _evaluate(self.engines, xbits, ybits)


def compile_candidates(schedules, device: str | torch.device = "cuda") -> CandidateBatch:
    """Candidate schedules (or pre-compiled engines) on one device.

    Accepts any mix of ``reduction.Schedule`` and ``CompiledSchedule``; all
    candidates must share the operand width (same ``n_digits``) so a single
    bit-packed batch feeds every replay, and a compiled one must sit on
    ``device``.
    """
    device = resolve_device(device)
    engines = tuple(
        s if isinstance(s, CompiledSchedule) else compile_schedule(s, device)
        for s in schedules
    )
    if len({e.schedule.n_digits for e in engines}) > 1:
        raise ValueError("candidates must share n_digits (one operand batch)")
    if any(e.device != device for e in engines):
        raise ValueError(f"compiled candidates must sit on {device}")
    return CandidateBatch(engines)


def evaluate_candidates_split(
    candidates, xbits: np.ndarray, ybits: np.ndarray, device: str | torch.device = "cuda",
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Candidate schedules on a shared batch.

    ``candidates`` is a ``CandidateBatch`` (its own device) or a sequence of
    schedules, compiled on the spot for ``device`` -- prefer building the
    batch once via ``compile_candidates`` when evaluating several chunks.
    """
    if not isinstance(candidates, CandidateBatch):
        candidates = compile_candidates(candidates, device)
    return candidates.evaluate_split(xbits, ybits)


def evaluate_digits_split(
    n_digits: int, border: int | None, x_digits: np.ndarray, y_digits: np.ndarray,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Convenience: digit arrays -> exact (lo, hi) via the cached engine."""
    xb = ppgen.flatten_operand_bits(x_digits)
    yb = ppgen.flatten_operand_bits(y_digits)
    return get_engine(n_digits, border, device).evaluate_split(xb, yb)


# --------------------------------------------------------------------------
# Error injection: the replay as a product evaluator over int8 operands
# --------------------------------------------------------------------------
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


def inject_products(schedule, ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """Exact AMR products of int8 operand indices (value + 128).

    ``schedule`` is a ``CompiledInjector`` or a raw ``reduction.Schedule``
    (compiled on the spot -- hold a ``CompiledInjector`` when calling from a
    hot loop; ``numerics.injection`` keeps the policy-level cache).
    """
    inj = schedule if isinstance(schedule, CompiledInjector) else compile_injector(schedule)
    return inj.products(ia, ib)
