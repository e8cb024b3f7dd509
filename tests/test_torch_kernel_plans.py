"""The host-side plans of the CUDA kernels, on the CPU.

The circuit-replay kernel compiles ``CELL_PAIRS``, the (sum, carry) truth
tables of the port's cells, as LOP3 immediates, and takes a program of runs
whose cells share one pair; a cell whose pair is outside that list runs in
the kernel's slow minterm form (``ReplayProgram.generic_ops``).  The list
must hold every pair the cells can produce, so that no schedule built from
them takes the slow form; PP gates run branch-free on their own bytes.  The
low-rank kernel's grid must fill the card at the rank-8 gemma-2b path's
shapes while its K chunks, and so its summation order, depend on K alone.
The SSD scan's plan covers every (chunk, batch, head, P slice) with one
block, in an order where a block only waits on lower tickets; the fused
kernels' T splits cover T in whole words and fit a block's shared memory.  The kernels themselves
run only on a GPU (tests/test_torch_kernels_cuda.py).
"""
import itertools
import math
import re

import numpy as np
import pytest

from repro_torch.core import engine, reduction
from repro_torch.core.cells import CELLS
from repro_torch.kernels.amr_matmul import kernel as mkernel
from repro_torch.kernels.attn_fused import kernel as akernel
from repro_torch.kernels.inject_replay import kernel as rkernel
from repro_torch.kernels.ssd_scan import kernel as skernel

BORDERS = [None] + list(range(21))
H100_SMS = 132
# the dense (M, K, N) of the rank-8 gemma-2b path: decode over 2 slots and a
# 16-token prefill at d_model 2048, d_ff 16384, 1 KV head and 8 query heads of 256
PATH_SHAPES = [(m, k, n) for m in (2, 16)
               for k, n in ((2048, 16384), (16384, 2048), (2048, 256), (2048, 2048))]


def _program(border):
    inj = engine.compile_injector(reduction.get_schedule(2, border))
    return rkernel.replay_program(inj.lowered, inj.value_bits)


def _runs(prog):
    """[(case, op records)] of a program."""
    out, i = [], 0
    while i < prog.ops.shape[0]:
        head, case = prog.ops[i]
        assert head >> 24 == 2
        count = int(head & 0xFFFFFF)
        out.append((int(case), prog.ops[i + 1:i + 1 + count]))
        i += 1 + count
    return out


@pytest.mark.parametrize("border", BORDERS)
def test_every_border_program_runs_on_immediates(border):
    """No cell of any border's program takes the minterm form: each run's
    cells carry the bytes of the pair its header names, and the runs are
    few (the kernel's switch is taken once a run)."""
    prog = _program(border)
    assert prog.generic_ops == 0
    runs = _runs(prog)
    assert len(runs) == prog.n_runs <= 30
    assert sum(len(ops) for _, ops in runs) == prog.n_ops == 201
    for case, ops in runs:
        for op0, op1 in ops:
            if op0 >> 24 == 1:
                assert rkernel.CELL_PAIRS[case] == ((op1 >> 16) & 0xFF, op1 >> 24)
            else:
                assert op0 >> 24 == 0


def test_cell_pairs_cover_every_cell_order():
    pairs = set(rkernel.CELL_PAIRS)
    assert list(rkernel.CELL_PAIRS) == sorted(pairs) and 0 < len(pairs) <= 32
    for cell in CELLS.values():
        tables = [np.tile(t, 8 // t.size) for t in (cell.sum_np, cell.carry_np)]
        for order in itertools.permutations(range(3)):
            pair = tuple(sum(1 << i for i in range(8)
                             if t[sum(((i >> (2 - order[p])) & 1) << (2 - p) for p in range(3))])
                         for t in tables)
            assert pair in pairs, (cell.name, order, pair)


@pytest.mark.parametrize("gate", range(4))
def test_gates_run_branch_free_on_their_bytes(gate):
    """A PP gate is x ? f(1, y) : f(0, y), each a select of y by the masks
    of bits 4x + 3 and 4x of its byte: the kernel's form gives the gate's
    table for every gate type the lowering emits."""
    tt = rkernel._gate_byte(engine._GATE_TABLES[gate])
    for x in (0, 1):
        for yv in (0, 1):
            got = ((tt >> (4 * x + 3)) & 1) if yv else ((tt >> (4 * x)) & 1)
            assert got == engine._GATE_TABLES[gate][2 * x + yv]


def test_cell_pairs_reach_the_kernel_build():
    """Both libraries that include the replay's device code get the list,
    four 16-bit (sum << 8 | carry) entries a definition."""
    from repro_torch.kernels.attn_fused import kernel as akernel

    for lib in (rkernel.LIBRARY, akernel.INJECT_LIBRARY):
        words = dict(f.removeprefix("-DREPLAY_CELL_PAIRS").removesuffix("ULL").split("=")
                     for f in lib.flags if f.startswith("-DREPLAY_CELL_PAIRS"))
        assert sorted(words, key=int) == [str(w) for w in range(8)]
        entries = [(int(words[str(i // 4)], 16) >> (16 * (i % 4))) & 0xFFFF for i in range(32)]
        built = tuple((e >> 8, e & 0xFF) for e in entries if e)
        assert built == rkernel.CELL_PAIRS and entries[len(built):] == [0] * (32 - len(built))


def test_a_pair_outside_the_list_is_counted_generic(monkeypatch):
    """A build without one of the served pairs would run its cells in the
    minterm form: the program says how many cells that is."""
    fa = (0x96, 0xE8)  # the exact full adder
    n_fa = sum(op0 >> 24 == 1 and ((op1 >> 16) & 0xFF, op1 >> 24) == fa
               for _, ops in _runs(_program(8)) for op0, op1 in ops)
    monkeypatch.setattr(rkernel, "_PAIR_INDEX",
                        {p: i for i, p in enumerate(rkernel.CELL_PAIRS) if p != fa})
    prog = _program(8)
    assert n_fa > 0 and prog.generic_ops == n_fa
    assert all(case == rkernel.GENERIC for case, ops in _runs(prog)
               if any(op0 >> 24 == 1 and ((op1 >> 16) & 0xFF, op1 >> 24) == fa
                      for op0, op1 in ops))


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_lowrank_grid_fills_the_card(m, k, n):
    rt, cgb, chunks, tiles = mkernel.lowrank_launch_shape(m, n, k, H100_SMS)
    assert tiles >= H100_SMS
    assert tiles == math.ceil(n / (4 * cgb)) * math.ceil(m / rt) * chunks
    assert rt == (2 if m <= 2 else 8) and cgb in (2, 4, 8, 16)


@pytest.mark.parametrize("k", [1, 255, 256, 257, 2048, 2048 + 96, 16384])
def test_lowrank_chunks_depend_on_k_alone(k):
    """The summation order is fixed by the chunks: the same for every M, N
    and card size."""
    chunks = {mkernel.lowrank_launch_shape(m, n, k, sms)[2]
              for m in (1, 2, 3, 16, 40) for n in (1, 77, 256, 16384) for sms in (1, 132)}
    assert chunks == {math.ceil(k / mkernel.LOWRANK_CHUNK)}


# (G, M, K, N) of the gather kernels on the rank-0 serve paths: the dense
# sites of gemma-2b (d_model 2048, d_ff 16384, 1 KV head and 8 query heads of
# 256) and of mamba2-370m (wz/wx, wb/wc, wdt, out_proj) at decode over 1 and
# 2 slots and in a 16-token prefill; attn.qk / attn.pv at decode over 1 and 2
# slots and in prefill; ssm.scan at decode over 2 and 1 slots and in prefill
GATHER_SHAPES = [(1, m, k, n) for m in (1, 2, 16)
                 for k, n in ((2048, 16384), (16384, 2048), (2048, 256), (2048, 2048),
                              (1024, 2048), (1024, 128), (1024, 32), (2048, 1024))]
GATHER_SHAPES += [(2, 8, 256, 24), (2, 8, 24, 256), (1, 8, 256, 24), (1, 8, 24, 256),
                  (1, 128, 256, 16), (1, 128, 16, 256), (64, 1, 128, 64), (32, 1, 128, 64),
                  (32, 256, 128, 64)]
# gemma3-1b (d_model 1152, d_ff 6912, 1 KV head and 4 query heads of 256):
# the dense sites at decode over 1 and 2 slots, in a 16-token and a
# 600-token prefill; attn.qk / attn.pv at decode against a 512-slot window
# ring, a 640-slot global cache and a 24-slot cache, in both prefills, and
# one 2048-query block of the chunked prefill at S = 16384
GATHER_SHAPES += [(1, m, k, n) for m in (1, 2, 16, 600)
                  for k, n in ((1152, 6912), (6912, 1152), (1152, 256), (1152, 1024),
                               (1024, 1152))]
GATHER_SHAPES += [(g, 4, k, n) for g in (1, 2) for t in (512, 640, 24)
                  for k, n in ((256, t), (t, 256))]
GATHER_SHAPES += [(1, 64, 256, 16), (1, 64, 16, 256), (1, 2400, 256, 600), (1, 2400, 600, 256),
                  (1, 8192, 256, 16384), (1, 8192, 16384, 256)]
SM90_SMEM_PER_BLOCK = 227 * 1024
SM90_SMEM_PER_SM = 228 * 1024          # an SM's shared memory, of which each block's
SM90_SMEM_RESERVED_PER_BLOCK = 1024    # launch reserves 1 KB (CUDA C++ Programming Guide)


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("g,m,k,n", GATHER_SHAPES)
def test_lut_plan_fills_the_card(g, m, k, n, int16):
    """At least 124 of the 132 SMs get a tile in the first round; the tiles
    are the groups x row tiles x column tiles x K splits of the plan."""
    plan = mkernel.lut_launch_plan(g, m, n, k, H100_SMS, int16)
    assert plan.tiles >= 124 and mkernel.fills_the_card(plan.tiles, H100_SMS)
    assert plan.tiles == (g * math.ceil(m / plan.rt) * math.ceil(n / (4 * plan.cg))
                          * plan.splits)
    assert plan.rt in mkernel.LUT_ROWS and plan.rt <= 1 << (m - 1).bit_length()
    assert plan.cg in (4, 8, 16, 32, 64, 128) and mkernel.LUT_THREADS % plan.cg == 0


@pytest.mark.parametrize("k", [1, 3, 4, 5, 24, 127, 128, 1000, 2047, 2048, 2050, 16384])
def test_lut_plan_puts_every_k_in_one_split(k):
    """k_chunk is a multiple of 4 and the splits tile K exactly, for every
    M, N and group count; the staged A rows fit their buffer."""
    for g, m, n in ((1, 1, 1), (1, 2, 16384), (1, 16, 256), (1, 17, 77), (64, 1, 64),
                    (32, 256, 64)):
        plan = mkernel.lut_launch_plan(g, m, n, k, H100_SMS, True)
        assert plan.k_chunk % 4 == 0 and plan.k_chunk >= 4
        assert (plan.splits - 1) * plan.k_chunk < k <= plan.splits * plan.k_chunk
        assert plan.rt * plan.k_chunk <= mkernel.LUT_A_ENTRIES


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("g,m,k,n", GATHER_SHAPES + [(1, 40, 1000, 513), (1, 16, 16384, 16384)])
def test_lut_plan_shared_memory_fits(g, m, k, n, int16):
    """A launch asks for at most the 227 KB a block may use; only the int16
    table is staged, and it is staged where the call has enough products."""
    plan = mkernel.lut_launch_plan(g, m, n, k, H100_SMS, int16)
    assert mkernel.lut_smem_bytes(plan) <= SM90_SMEM_PER_BLOCK
    assert plan.staged == (int16 and g * m * n * k >= mkernel.LUT_STAGE_MIN_PRODUCTS)
    widest = plan._replace(rt=16, cg=mkernel.LUT_MAX_CG,
                           k_chunk=mkernel.LUT_A_ENTRIES // 16, staged=True)
    assert mkernel.lut_smem_bytes(widest) <= SM90_SMEM_PER_BLOCK


def test_lut_constants_match_the_source():
    """The plan's block size, staged-A capacity, widest block and table size
    are the CUDA source's."""
    text = mkernel.LUT_LIBRARY.source.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert eval(consts["kThreads"]) == mkernel.LUT_THREADS
    assert eval(consts["kAEntries"]) == mkernel.LUT_A_ENTRIES
    assert eval(consts["kMaxCg"]) == mkernel.LUT_MAX_CG
    header = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", mkernel.GATHER_HEADER.read_text()))
    assert eval(header["kTableBytes16"]) == mkernel.LUT_TABLE_BYTES
    assert mkernel.GATHER_HEADER in mkernel.LUT_LIBRARY.headers


# (G, M, K, N) of the amr_inject gemma-2b path: the dense sites at decode and
# prefill, and the grouped attention products
REPLAY_SHAPES = [(1, m, k, n) for m, k, n in PATH_SHAPES] + [
    (2, 8, 256, 24), (2, 8, 24, 256), (1, 128, 256, 16), (1, 128, 16, 256)]


@pytest.mark.parametrize("per_sm", [(1, 5), (2, 6)])
@pytest.mark.parametrize("g,m,k,n", REPLAY_SHAPES)
def test_replay_launch_fills_the_card(g, m, k, n, per_sm):
    """At most one wave of the blocks the SMs hold (``per_sm``, the
    kernel's occupancy with ITEMS and with 1 item a thread), at the least K
    per block that keeps to one wave, or a single k step a block; ITEMS
    items a thread at the four large dense shapes; every k in exactly one
    block's chunk."""
    wpb, rpb, k_chunk, items = rkernel.launch_shape(g, m, n, k, H100_SMS, per_sm)
    kpb = rkernel.THREADS // (wpb * rpb)
    assert wpb * rpb * kpb == rkernel.THREADS and items in (1, rkernel.ITEMS)
    assert (wpb, rpb) == rkernel.replay_block(m, n) and rpb == min(16, 1 << (m - 1).bit_length())
    splits = math.ceil(k / k_chunk)
    assert (splits - 1) * k_chunk < k <= splits * k_chunk
    tiles = g * math.ceil(math.ceil(n / 32) / wpb) * math.ceil(m / rpb)
    fit = per_sm[0] if items == rkernel.ITEMS else per_sm[1]
    assert tiles * splits <= max(tiles, fit * H100_SMS)
    assert tiles * math.ceil(k / max(1, k_chunk - 1)) > fit * H100_SMS or k_chunk <= kpb * items
    if k * n >= 2048 * 16384:
        assert items == rkernel.ITEMS


def test_replay_launch_takes_one_item_where_more_do_not_fit():
    """A program whose wire slots leave no room for ITEMS items a thread
    still runs, with 1; one that fits no block at all is refused."""
    assert rkernel.launch_shape(1, 2, 16384, 2048, H100_SMS, (0, 3))[3] == 1
    with pytest.raises(ValueError, match="fits"):
        rkernel.launch_shape(1, 2, 16384, 2048, H100_SMS, (0, 0))


def _all_kernels():
    from repro_torch.kernels.amr_matmul import kernel as amr
    from repro_torch.kernels.attn_fused import kernel as attn
    from repro_torch.kernels.rms_norm import kernel as norm
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return amr.KERNELS + rkernel.KERNELS + ssd.KERNELS + attn.KERNELS + norm.KERNELS


@pytest.mark.parametrize("kern", _all_kernels(), ids=lambda k: k.name)
def test_bindings_match_the_c_signatures(kern):
    """Each binding's ctypes argument types are the exported C function's
    parameters, in order (a mismatch shows on the card only as a refused
    call or a cut pointer)."""
    import ctypes
    import re

    text = kern.library.source.read_text()
    match = re.search(rf"\bint {kern.symbol}\(([^)]*)\)\s*{{", text)
    assert match, f"{kern.symbol} not found in {kern.library.source}"
    kinds = []
    for param in match.group(1).split(","):
        decl = " ".join(param.split())
        kinds.append(ctypes.c_void_p if "*" in decl else
                     ctypes.c_longlong if decl.startswith("long long") else
                     ctypes.c_float if decl.startswith("float") else ctypes.c_int)
    assert kern.argtypes == kinds


# (B, S, H, P, N, chunk) of the SSD scan: mamba2-370m's prefill of a 16-token
# prompt, 1024 and 2048 tokens (4 and 8 chunks of 256: below and above the
# SM count), and the CUDA tests' shapes (ragged chunks, G < H, small widths)
SSD_SHAPES = [(1, 16, 32, 64, 128, 256), (1, 1024, 32, 64, 128, 256),
              (1, 2048, 32, 64, 128, 256), (2, 300, 8, 32, 64, 128), (1, 37, 4, 16, 16, 16),
              (1, 8, 2, 16, 16, 16), (2, 5000, 32, 64, 128, 256), (1, 700, 3, 48, 64, 256)]


def _ssd_item(plan, ticket, B, H):
    """(chunk, batch, head, first column of P) of the SSD block that takes
    ``ticket``, decoded as ssd_scan.cu decodes it: chunk-major, then batch,
    head and P slice."""
    chunk, rem = divmod(ticket, B * H * plan.p_split)
    batch, rem = divmod(rem, H * plan.p_split)
    head, ps = divmod(rem, plan.p_split)
    return chunk, batch, head, ps * plan.p_block


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plan_covers_every_item_once(B, S, H, P, N, chunk):
    """Tickets 0 .. blocks - 1 name every (chunk, batch, head, P slice)
    once, and the block a chunk's block waits on (the same batch, head and
    slice one chunk before) holds a lower ticket."""
    plan = skernel.ssd_launch_plan(B, S, H, P, N, chunk, H100_SMS)
    assert plan.chunks == math.ceil(S / chunk)
    assert plan.p_block in skernel.P_BLOCKS and plan.p_block * plan.p_split == P
    assert N * plan.p_block <= skernel.MAX_STATE_TILE
    tickets = {_ssd_item(plan, t, B, H): t for t in range(plan.blocks)}
    want = {(c, b, h, p0) for c in range(plan.chunks) for b in range(B) for h in range(H)
            for p0 in range(0, P, plan.p_block)}
    assert set(tickets) == want and len(tickets) == plan.blocks
    for (c, b, h, p0), t in tickets.items():
        if c > 0:
            assert tickets[(c - 1, b, h, p0)] < t


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plan_fills_the_card_where_the_shape_allows(B, S, H, P, N, chunk):
    """A P split only where the chunks x batch x heads leave SMs empty: the
    widest slice that fills the card, else the narrowest (16 columns)."""
    plan = skernel.ssd_launch_plan(B, S, H, P, N, chunk, H100_SMS)
    base = plan.chunks * B * H
    if mkernel.fills_the_card(base, H100_SMS):
        assert plan.p_split == 1 or plan.p_block == max(
            pb for pb in skernel.P_BLOCKS if P % pb == 0 and N * pb <= skernel.MAX_STATE_TILE)
    else:
        assert mkernel.fills_the_card(plan.blocks, H100_SMS) or plan.p_block == 16
    assert skernel.ssd_launch_plan(1, 16, 32, 64, 128, 256, H100_SMS).blocks == 128
    assert skernel.ssd_launch_plan(1, 1024, 32, 64, 128, 256, H100_SMS).p_split == 1


@pytest.mark.parametrize("p_block", skernel.P_BLOCKS)
def test_ssd_plan_fits_shared_memory(p_block):
    """At N = 128 and chunk 256 (mamba2-370m) a block fits the 227 KB a
    block may use, whatever the P slice; the plan reports the source's
    formula."""
    assert skernel.ssd_smem_bytes(128, 256, p_block) <= SM90_SMEM_PER_BLOCK
    plan = skernel.ssd_launch_plan(1, 2048, 32, 64, 128, 256, H100_SMS)
    assert plan.smem == skernel.ssd_smem_bytes(128, 256, plan.p_block) <= SM90_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="d_state"):
        skernel.ssd_launch_plan(1, 16, 2, 16, 1024, 256, H100_SMS)


def test_ssd_constants_match_the_source():
    text = skernel.LIBRARY.source.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;/]+);", text))
    assert int(consts["kThreads"]) == skernel.THREADS
    assert int(consts["kTile"]) == skernel.TILE
    assert int(consts["kMaxN"]) == skernel.MAX_N
    assert int(consts["kMaxStateTile"]) == skernel.MAX_STATE_TILE


def test_ssd_bwd_constants_and_shared_memory_match_the_source():
    """The backward's limits and tiles are the source's, and two blocks'
    shared memory fits an SM at both models' widths (mamba2-370m: N 128, P
    64; zamba2-1.2b: N 64, P 64; chunk 256) and at the largest the kernel
    takes, as ``__launch_bounds__(kThreads, 2)`` asks."""
    text = skernel.LIBRARY_BWD.source.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;/]+);", text))
    assert int(consts["kThreads"]) == skernel.BWD_THREADS
    assert int(consts["kS"]) == skernel.BWD_S_TILE
    assert int(consts["kT"]) == skernel.BWD_T_TILE
    assert int(consts["kMaxN"]) == skernel.MAX_N
    assert int(consts["kMaxP"]) == skernel.BWD_MAX_P
    assert int(consts["kParts"]) == skernel.BWD_PARTS
    assert "constexpr int kLdM = kS + 4;" in text
    assert "__launch_bounds__(kThreads, 2)" in text
    for n, p in ((128, 64), (64, 64), (skernel.MAX_N, skernel.BWD_MAX_P)):
        assert 2 * (skernel.ssd_bwd_smem_bytes(n, p, 256) + SM90_SMEM_RESERVED_PER_BLOCK) \
            <= SM90_SMEM_PER_SM
    assert skernel.ssd_bwd_smem_bytes(128, 64, 256) == 100352


def _inject_plan(G, M, D, T, P, bm=None, border=8):
    prog = _program(border)
    bm = akernel.default_row_tile(G, M, "inject", T, H100_SMS) if bm is None else bm
    return akernel.inject_launch_plan(G, M, D, T, P, bm, H100_SMS, prog.n_slots,
                                      prog.n_opbits, prog.ops.shape[0])


# (G, M, D, T, P) of the fused attention op at gemma-2b's width: the long
# decode, the served decode and prefill, the inject long prefill; and the
# CUDA tests' shapes (T off a word, small widths)
INJECT_SHAPES = [(2, 8, 256, 8192, 256), (2, 8, 256, 24, 256), (1, 128, 256, 16, 256),
                 (1, 2048, 256, 256, 256), (3, 6, 40, 70, 33), (1, 64, 16, 1000, 24),
                 (2, 8, 256, 1000, 256), (1, 2, 16, 60000, 8)]


@pytest.mark.parametrize("bm", [None, 1, 2])
@pytest.mark.parametrize("G,M,D,T,P", INJECT_SHAPES)
def test_inject_t_split_covers_t_in_whole_words(G, M, D, T, P, bm):
    """The slices cover T's words once, the last one partial where T is
    not a multiple of 32; the state and score scratch have the kernel's
    sizes; a block's shared memory fits."""
    plan = _inject_plan(G, M, D, T, P, bm)
    n_words = math.ceil(T / 32)  # the slices as attn_fused_inject.cu takes them
    words = [(w, min(n_words, w + plan.slice_words)) for w in range(0, n_words, plan.slice_words)]
    assert len(words) == plan.slices and words[0][0] == 0
    assert words[-1][1] == math.ceil(T / 32)
    assert all(a < b and b == c for (a, b), (c, _) in zip(words, words[1:] + [(words[-1][1], 0)]))
    assert all(b - a == plan.slice_words for a, b in words[:-1])
    assert min(T, 32 * words[-1][1]) - 32 * words[-1][0] >= 1
    tiles = G * (M // plan.bm)
    assert plan.blocks == (1 if plan.whole else 2) * tiles * plan.slices
    assert not plan.whole or plan.slices == 1
    assert plan.state_words == 1 + akernel.TILE_WORDS * tiles + G * M * P
    assert plan.score_words == G * M * 32 * math.ceil(T / 32) + G * M
    assert plan.smem <= SM90_SMEM_PER_BLOCK and plan.items in (1, rkernel.ITEMS)
    for wpb, rpb in ((plan.qk_wpb, plan.qk_rpb), (plan.pv_wpb, plan.pv_rpb)):
        assert rkernel.THREADS % (wpb * rpb) == 0 and wpb & (wpb - 1) == 0


def test_inject_t_split_fills_the_card_at_the_long_decode():
    """gemma-2b's 8192-token decode (8 rows a group, 2 groups) runs at
    least 132 blocks of each kind, in row tiles of all 8 rows (K^T and V
    packed once for the 8), ITEMS k values a thread; the served decode and
    prefill keep one slice."""
    plan = _inject_plan(2, 8, 256, 8192, 256)
    assert plan.bm == 8 and plan.blocks // 2 >= H100_SMS and plan.items == rkernel.ITEMS
    assert not plan.whole
    for G, M, T in ((2, 8, 24), (1, 128, 16)):
        plan = _inject_plan(G, M, 256, T, 256)
        assert plan.slices == 1 and plan.whole and plan.blocks == G * M // plan.bm


def test_inject_constants_match_the_source():
    text = akernel.INJECT_LIBRARY.source.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;/]+);", text))
    assert int(consts["kThreads"]) == rkernel.THREADS
    assert int(consts["kItems"]) == rkernel.ITEMS
    assert int(consts["kMaxSmem"]) == akernel.SMEM_LIMIT
    header = akernel.TSPLIT_HEADER.read_text()
    assert int(re.search(r"constexpr int kTileWords = (\d+);", header).group(1)) == \
        akernel.TILE_WORDS


def _lut_attn_plan(G, M, D, T, P, bm=None, int16=True):
    bm = akernel.default_row_tile(G, M, "lut", T, H100_SMS) if bm is None else bm
    return akernel.lut_attn_launch_plan(G, M, D, T, P, bm, H100_SMS, int16)


# (G, M, D, T, P) of the fused LUT op at gemma-2b's width: the long decode,
# the served decode and prefill, the lut long prefill (S = 1024) and 128
# rows over the long context; and the CUDA tests' shapes (T off a word,
# small widths, T beyond what a block's shared memory holds)
LUT_ATTN_SHAPES = [(2, 8, 256, 8192, 256), (2, 8, 256, 24, 256), (1, 128, 256, 16, 256),
                   (1, 8192, 256, 1024, 256), (2, 64, 256, 8192, 256), (1, 256, 256, 256, 256),
                   (3, 6, 40, 70, 33), (1, 64, 16, 1000, 24), (2, 8, 256, 1000, 256),
                   (1, 16, 64, 300, 40), (2, 4, 32, 33, 8), (1, 2, 16, 60000, 8)]


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("bm", [None, 1, 2])
@pytest.mark.parametrize("G,M,D,T,P", LUT_ATTN_SHAPES)
def test_lut_attn_t_split_covers_t_in_whole_words(G, M, D, T, P, bm, int16):
    """The slices cover T's words once, the last one partial where T is
    not a multiple of 32; the state and score scratch have the kernel's
    sizes (none for a whole row tile); the sub-tile and the tiles' column
    groups are ones the kernel takes."""
    plan = _lut_attn_plan(G, M, D, T, P, bm, int16)
    n_words = math.ceil(T / 32)  # the slices as attn_fused_lut.cu takes them
    words = [(w, min(n_words, w + plan.slice_words)) for w in range(0, n_words, plan.slice_words)]
    assert len(words) == plan.slices and words[0][0] == 0 and words[-1][1] == n_words
    assert all(b - a == plan.slice_words for a, b in words[:-1])
    assert min(T, 32 * words[-1][1]) - 32 * words[-1][0] >= 1
    tiles = G * (M // plan.bm)
    assert plan.blocks == (tiles if plan.whole else min(2 * tiles * plan.slices, H100_SMS))
    assert not plan.whole or plan.slices == 1
    if plan.whole:
        assert plan.state_words == plan.score_words == 0
    else:
        assert plan.state_words == 1 + akernel.TILE_WORDS * tiles + G * M * P
        assert plan.score_words == G * M * 32 * n_words + 3 * G * M
    assert plan.rt in (1, 2, 4, 8, 16) and min(plan.bm, 16) <= plan.rt < 2 * min(plan.bm, 16)
    for cg in (plan.qk_cg, plan.pv_cg):
        assert cg in (4, 8, 16, 32, 64) and cg <= akernel.LUT_MAX_CG
    assert 4 * plan.qk_cg >= min(T, 32 * plan.slice_words, 128)
    assert 4 * plan.pv_cg >= min(P, 4 * akernel.LUT_MAX_CG)


@pytest.mark.parametrize("G,M,D,T,P", LUT_ATTN_SHAPES)
def test_lut_attn_shared_memory_fits(G, M, D, T, P):
    """Every plan the wrapper takes fits a block, the staged table
    included; the int16 table is staged where the call has enough
    products, the int32 table (256 KB) never; one slice runs whole where
    the row tiles take at most one wave of the card and a row tile's scores
    fit beside the rest, else through the split join."""
    for bm in (None, 1, 2):
        for int16 in (True, False):
            plan = _lut_attn_plan(G, M, D, T, P, bm, int16)
            assert plan.smem <= SM90_SMEM_PER_BLOCK
            assert plan.staged == (int16 and G * M * T * (D + P) >= mkernel.LUT_STAGE_MIN_PRODUCTS)
            if plan.slices == 1 and not plan.whole:
                whole = akernel.lut_attn_plan(G, M, D, T, P, plan.bm, H100_SMS,
                                              slice_words=plan.slice_words,
                                              staged=plan.staged, whole=True)
                assert whole.smem > SM90_SMEM_PER_BLOCK or whole.blocks > H100_SMS
    widest = akernel.lut_attn_plan(1, 16, 256, 8192, 256, 16, H100_SMS, slice_words=4,
                                   staged=True, whole=False)
    assert widest.rt == 16 and widest.pv_cg == akernel.LUT_MAX_CG
    assert widest.smem <= SM90_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="whole row tile"):
        akernel.lut_attn_plan(2, 8, 256, 8192, 256, 8, H100_SMS, slice_words=4, staged=True,
                              whole=True)


def test_lut_attn_t_split_fills_the_card_at_the_long_decode():
    """gemma-2b's 8192-token decode (8 rows a group, 2 groups) runs QK^T
    and PV items that fill the card, in row tiles of all 8 rows (a K^T
    column offset and a V load serve the 8), on the staged table; the
    served decode and prefill keep one slice on the whole path; the long
    prefill's 512 row tiles of 16 rows keep one slice on persistent blocks."""
    plan = _lut_attn_plan(2, 8, 256, 8192, 256)
    assert plan.bm == plan.rt == 8 and not plan.whole and plan.staged
    assert mkernel.fills_the_card(2 * plan.slices, H100_SMS) and plan.blocks == H100_SMS
    for G, M, T in ((2, 8, 24), (1, 128, 16)):
        plan = _lut_attn_plan(G, M, 256, T, 256)
        assert plan.slices == 1 and plan.whole and plan.blocks == G * M // plan.bm
        assert not plan.staged
    plan = _lut_attn_plan(1, 8192, 256, 1024, 256)
    assert plan.bm == 16 and plan.slices == 1 and not plan.whole and plan.staged
    assert plan.blocks == H100_SMS


def test_lut_attn_constants_match_the_source():
    text = akernel.LUT_LIBRARY.source.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;/]+);", text))
    assert int(consts["kMaxRows"]) == akernel.MAX_ROWS
    assert int(consts["kMaxCg"]) == akernel.LUT_MAX_CG
    assert int(consts["kAWords"]) == akernel.LUT_A_WORDS
    assert int(consts["kMaxSmem"]) == akernel.SMEM_LIMIT
    assert mkernel.GATHER_HEADER in akernel.LUT_LIBRARY.headers
    assert akernel.TSPLIT_HEADER in akernel.LUT_LIBRARY.headers
