"""Wallace-tree partial-product reduction with exact/approximate cells.

Copied from the JAX package's ``core/reduction.py``, with its pluggable
DSE-assigner hook, so a whole-multiplier DSE candidate can be rebuilt here.

Builds a *static schedule*: stages of (cell, input-bit-ids, output-bit-ids)
until every column holds at most two bits. Bit-accurate evaluation then
replays the schedule vectorised over a batch (numpy uint8).

Region policy per column ``p`` and border ``b`` (paper §III):
  * approximate part, ``p < b``  : approximate FAs chosen by the DSE + exact HA
  * border column,    ``p == b`` : DSE may additionally pick exact FAs
  * exact part,       ``p > b``  : exact FA/HA only
``b = None`` gives the exact MRSD multiplier.

Expected-error bookkeeping: the DSE receives the accumulated expected
multiplier error scaled into units of the current column weight
(``E / 2**p``), maintained exactly with ``Fraction`` — a unit of error at
column p-1 weighs half a unit at column p (see DESIGN.md on the Fig. 3
error-carry interpretation).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from fractions import Fraction
from functools import lru_cache

import numpy as np

from . import ppgen
from .cells import CELLS, output_polarity
from .dse import assign_column


@dataclasses.dataclass
class CellGroup:
    """All same-type cells of one stage, vectorised."""

    name: str
    in_ids: np.ndarray      # (n_cells, n_in) int64 bit ids
    sum_ids: np.ndarray     # (n_cells,) output bit ids
    carry_ids: np.ndarray   # (n_cells,) output bit ids


@dataclasses.dataclass
class Schedule:
    n_digits: int
    border: int | None
    layout: ppgen.PPLayout
    stages: list[list[CellGroup]]
    n_bits: int                     # total wires incl. PP bits
    bit_polarity: np.ndarray        # (n_bits,) 0 pos / 1 neg
    final_ids: np.ndarray           # bit ids surviving reduction
    final_positions: np.ndarray
    expected_error: Fraction        # accumulated expected (mean) value error
    cell_counts: dict[str, int]
    dse_nodes: int

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def build_schedule(n_digits: int, border: int | None, assigner=None) -> Schedule:
    """Build the static reduction schedule for one design point.

    ``assigner`` is the pluggable DSE policy for approx/border columns:
    ``assigner(p, pos_cnt, neg_cnt, err_scaled, allow_exact_fa)`` returns the
    ``(cell, dp, dn)`` list to instantiate (``err_scaled`` is the accumulated
    expected error in units of ``2**p``).  ``None`` (the default, and the
    only policy the ``get_schedule`` cache ever uses) runs the paper's
    per-column Fig. 3 branch-and-bound (``dse.assign_column``); a replay
    policy that re-emits a recorded whole-multiplier assignment rebuilds a
    DSE candidate.  The exact region takes exact FAs on triples, posibits
    first.
    """
    layout = ppgen.build_pp_layout(n_digits)
    n_pp = layout.n_pp

    bit_pol: list[int] = list(layout.polarity.astype(int))
    # columns: position -> (list of pos bit ids, list of neg bit ids)
    cols: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
    for bid in range(n_pp):
        p = int(layout.position[bid])
        cols[p][int(layout.polarity[bid])].append(bid)

    def new_bit(pol: int) -> int:
        bit_pol.append(pol)
        return len(bit_pol) - 1

    stages: list[list[CellGroup]] = []
    e_abs = Fraction(0)  # exact expected multiplier error so far
    cell_counts: dict[str, int] = defaultdict(int)
    dse_nodes = 0

    def col_height(c):
        return len(c[0]) + len(c[1])

    while any(col_height(c) > 2 for c in cols.values()):
        groups: dict[str, list] = defaultdict(list)  # name -> (in_ids, sum_id, carry_id, neg_in)
        next_cols: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))

        for p in sorted(cols.keys()):
            pos_bits, neg_bits = cols[p]
            h = len(pos_bits) + len(neg_bits)
            if h == 1:
                for bid in pos_bits + neg_bits:
                    next_cols[p][bit_pol[bid]].append(bid)
                continue
            # h == 2: Wallace groups every column each stage — an HA here
            # absorbs the neighbour's incoming carry and avoids a ripple tail
            # of height-3 columns (which would serialise the tree).

            region_approx = border is not None and p < border
            region_border = border is not None and p == border

            chosen: list[tuple[str, int, int]]
            if (region_approx or region_border) and assigner is not None:
                chosen = list(assigner(
                    p, len(pos_bits), len(neg_bits),
                    e_abs / Fraction(2**p), region_border,
                ))
            elif region_approx or region_border:
                res = assign_column(
                    len(pos_bits), len(neg_bits),
                    e_abs / Fraction(2**p),
                    allow_exact_fa=region_border,
                )
                dse_nodes += res.nodes
                chosen = res.cells
            else:
                # exact region: FAs on triples, posibits first
                chosen = []
                np_, nn_ = len(pos_bits), len(neg_bits)
                while np_ + nn_ >= 3:
                    dp = min(3, np_)
                    dn = 3 - dp
                    chosen.append(("FA", dp, dn))
                    np_ -= dp
                    nn_ -= dn

            pq = list(pos_bits)
            nq = list(neg_bits)
            for name, dp, dn, in chosen:
                ins = [pq.pop() for _ in range(dp)] + [nq.pop() for _ in range(dn)]
                spol, cpol = output_polarity(3, dn)
                sid = new_bit(int(spol))
                cid = new_bit(int(cpol))
                groups[name].append((ins, sid, cid))
                cell_counts[name] += 1
                next_cols[p][int(spol)].append(sid)
                next_cols[p + 1][int(cpol)].append(cid)
                if CELLS[name].approx:
                    e_abs += Fraction(CELLS[name].avg_err).limit_denominator(4) * (2**p)

            # remainder: 2 bits -> exact HA, 1 bit -> pass-through
            rem = pq + nq
            if len(rem) == 2:
                dn = sum(1 for b in rem if bit_pol[b] == 1)
                spol, cpol = output_polarity(2, dn)
                # order inputs pos-first for a deterministic 2-bit index
                rem = sorted(rem, key=lambda b: bit_pol[b])
                sid = new_bit(int(spol))
                cid = new_bit(int(cpol))
                groups["HA"].append((rem, sid, cid))
                cell_counts["HA"] += 1
                next_cols[p][int(spol)].append(sid)
                next_cols[p + 1][int(cpol)].append(cid)
            elif len(rem) == 1:
                b = rem[0]
                next_cols[p][bit_pol[b]].append(b)

        stage_groups = []
        for name, items in sorted(groups.items()):
            in_ids = np.array([i[0] for i in items], dtype=np.int64)
            sum_ids = np.array([i[1] for i in items], dtype=np.int64)
            carry_ids = np.array([i[2] for i in items], dtype=np.int64)
            stage_groups.append(CellGroup(name, in_ids, sum_ids, carry_ids))
        stages.append(stage_groups)
        cols = next_cols

    final_ids = []
    final_positions = []
    for p in sorted(cols.keys()):
        for bid in cols[p][0] + cols[p][1]:
            final_ids.append(bid)
            final_positions.append(p)

    return Schedule(
        n_digits=n_digits,
        border=border,
        layout=layout,
        stages=stages,
        n_bits=len(bit_pol),
        bit_polarity=np.array(bit_pol, dtype=np.uint8),
        final_ids=np.array(final_ids, dtype=np.int64),
        final_positions=np.array(final_positions, dtype=np.int64),
        expected_error=e_abs,
        cell_counts=dict(cell_counts),
        dse_nodes=dse_nodes,
    )


@lru_cache(maxsize=None)
def get_schedule(n_digits: int, border: int | None) -> Schedule:
    """Process-level schedule cache: build_schedule + DSE run once per design
    point."""
    return build_schedule(n_digits, border)


_SPLIT = 32  # result value = lo + hi * 2**_SPLIT, both exact int64


def evaluate_split(
    schedule: Schedule, xbits: np.ndarray, ybits: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Replay the schedule; returns the result as exact split integers.

    xbits/ybits: (batch, 5N) stored operand bits (ppgen.flatten_operand_bits).
    Returns (lo, hi) int64 with value = lo + hi * 2**32 — 8-digit products
    reach ~2**69, beyond both int64 and the float64 mantissa, so all exact
    arithmetic is done in this split form.
    """
    batch = xbits.shape[0]
    vals = np.zeros((batch, schedule.n_bits), dtype=np.uint8)
    vals[:, : schedule.layout.n_pp] = ppgen.eval_pp_bits(schedule.layout, xbits, ybits)

    for stage in schedule.stages:
        # all groups in a stage read the *pre-stage* wire values; outputs are
        # fresh wires, so in-place writes to new ids are race-free.
        for g in stage:
            cell = CELLS[g.name]
            ins = vals[:, g.in_ids]  # (batch, n_cells, n_in)
            if cell.n_in == 3:
                idx = (ins[..., 0] << 2) | (ins[..., 1] << 1) | ins[..., 2]
            else:
                idx = (ins[..., 0] << 1) | ins[..., 1]
            vals[:, g.sum_ids] = cell.sum_np[idx]
            vals[:, g.carry_ids] = cell.carry_np[idx]

    stored = vals[:, schedule.final_ids].astype(np.int64)
    pos = schedule.final_positions
    pol = schedule.bit_polarity[schedule.final_ids].astype(np.int64)
    lo_mask = pos < _SPLIT
    w_lo = np.where(lo_mask, 1 << np.minimum(pos, _SPLIT - 1), 0).astype(np.int64)
    w_hi = np.where(~lo_mask, 1 << np.maximum(pos - _SPLIT, 0), 0).astype(np.int64)
    lo = (stored * w_lo).sum(-1) - int((pol * w_lo).sum())
    hi = (stored * w_hi).sum(-1) - int((pol * w_hi).sum())
    return lo, hi


def split_to_float(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return hi.astype(np.float64) * float(1 << _SPLIT) + lo.astype(np.float64)
