"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
no CUDA device is present (this is decided when the test runs, never at
import).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: the integer gather kernels and the circuit-replay kernel are
compared bit for bit (also at border 14, whose products exceed int16); the
low-rank kernel sums the same float32 terms as its plain version in another
order: |kernel - plain| <= 1e-5 * max_mn sum_k (|a b| + sum_r |u v|); the
SSD scan kernel likewise, within ``ssd_scan.ref.ssd_error_bound`` of its
plain version per output (the sums' roundings and those of the cumulative
log decay, relative to the same function of the absolute values, per
batch, chunk and head); copies of the SSD source with a planted fault must
fail that check on inputs whose carried state shows.  The fused attention
kernels equal their plain versions bit for bit (their softmax sums in the
plain version's order), for every row tile, and the op stays within
``attn_fused.ref.flip_tolerance`` of the unfused seam composition; copies
of the LUT kernel with a planted fault in its softmax must fail the bitwise
check.
"""
import ctypes
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import mamba2_370m
from repro_torch.configs.gemma_2b import reduced
from repro_torch.core import lut
from repro_torch.core import engine, reduction
from repro_torch.kernels.amr_matmul import kernel, ops, ref
from repro_torch.kernels import build
from repro_torch.kernels.attn_fused import kernel as akernel
from repro_torch.kernels.attn_fused import ops as aops
from repro_torch.kernels.attn_fused import ref as aref
from repro_torch.kernels.build import CudaKernel, CudaLibrary, build_all
from repro_torch.kernels.inject_replay import kernel as rkernel
from repro_torch.kernels.inject_replay import ref as rref
from repro_torch.kernels.rms_norm import kernel as nkernel
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.models import init_params
from repro_torch.models.tree import tree_map
from repro_torch.numerics import AMRNumerics
from repro_torch.numerics import injection
from repro_torch.numerics.quant import quantize_int8
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _int8(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=device, dtype=torch.int8)


def test_kernels_build(cuda, capsys):
    records = build_all(list(kernel.LIBRARIES) + list(rkernel.LIBRARIES)
                        + list(skernel.LIBRARIES) + list(akernel.LIBRARIES)
                        + list(nkernel.LIBRARIES))
    with capsys.disabled():
        for name, rec in records.items():
            print(f"\n[build] {name}: {rec.seconds:.1f}s\n{rec.log}")


# the gather kernels' path shapes (gemma-2b and mamba2-370m at decode and
# prefill) and ragged ones: M of 1, 3, 15, 17 about the row tiles; N off the
# 4 columns a thread and the block's columns; K off 4 and off the K splits
LUT_SHAPES = [(1, 1, 1), (2, 2048, 256), (3, 100, 77), (16, 2048, 300), (40, 1000, 513),
              (2, 2048, 16384), (2, 16384, 2048), (2, 2048, 2048), (16, 2048, 16384),
              (16, 16384, 2048), (16, 2048, 2048), (16, 2048, 256), (1, 2048, 16384),
              (2, 1024, 2048), (2, 1024, 128), (2, 1024, 32), (2, 2048, 1024),
              (16, 1024, 2048), (16, 1024, 128), (16, 1024, 32), (16, 2048, 1024),
              (15, 2050, 1030), (17, 4099, 254), (1, 2047, 4098), (3, 513, 3)]
LUT_GROUPED_SHAPES = [(2, 8, 256, 24), (2, 8, 24, 256), (1, 128, 256, 16), (5, 3, 70, 33),
                      (1, 128, 16, 256), (64, 1, 128, 64), (32, 256, 128, 64), (2, 1, 128, 64),
                      (3, 17, 130, 65), (64, 2, 9, 3)]


def _one_kernel_a_call(kern, fn, *args, calls=5):
    """The result of ``fn(*args)``, checked over ``calls`` calls to count one
    launch a call on ``kern`` and, under torch.profiler, to run no CUDA
    kernel but that one (no zero-fill or other launch beside it; the
    profiler may miss a short kernel's record, so its count is checked to
    be at most one a call).  A call before them allocates the stream's
    zeroed counters and accumulator where this shape is the first to need
    them (once a stream and size), under a first profiler session that
    starts the profiler's tracing.  A window that recorded no CUDA event at
    all observed nothing, and is run again, up to 3 windows in all; one
    that recorded any event is checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn(*args)
        torch.cuda.synchronize()
    for _ in range(3):
        before = kern.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            outs = [fn(*args) for _ in range(calls)]
            torch.cuda.synchronize()
        assert kern.launches == before + calls
        device_events = [(ev.key, ev.count) for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA]
        if device_events:
            break
    assert len(device_events) == 1 and "amr_lut_kernel" in device_events[0][0], device_events
    assert 1 <= device_events[0][1] <= calls, device_events
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    return outs[0]


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("m,k,n", LUT_SHAPES)
def test_lut_kernel_bitwise(cuda, border, m, k, n):
    a, b = _int8((m, k), 0, cuda), _int8((k, n), 1, cuda)
    table = ops.kernel_table(border, cuda)
    got = _one_kernel_a_call(kernel.LUT, kernel.amr_matmul_int8_lut, a, b, table)
    want = ref.lut_matmul_ref(a, b, lut.table_tensor(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("g,m,k,n", LUT_GROUPED_SHAPES)
def test_lut_grouped_kernel_bitwise(cuda, border, g, m, k, n):
    a, b = _int8((g, m, k), 2, cuda), _int8((g, k, n), 3, cuda)
    got = _one_kernel_a_call(kernel.LUT_GROUPED, kernel.amr_matmul_int8_lut_grouped, a, b,
                             ops.kernel_table(border, cuda))
    want = ref.lut_matmul_ref(a, b, lut.table_tensor(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _other_plans(g, m, k, n, int16):
    """Launch plans beside the wrapper's: each row tile, the narrowest, a
    middle and the widest block, K a tile of 4, 60 and the most the staged
    A holds (at most 65536 tiles), each on both table routes (int16 only)."""
    plans = {kernel.lut_launch_plan(g, m, n, k, 132, int16)}
    for rt in kernel.LUT_ROWS:
        for cg in (4, 32, kernel.LUT_MAX_CG):
            for k_chunk in (4, 60, kernel.LUT_A_ENTRIES // rt):
                k_chunk = min(k_chunk, 4 * -(-k // 4))
                splits = -(-k // k_chunk)
                tiles = g * -(-m // rt) * -(-n // (4 * cg)) * splits
                for staged in {False, int16}:
                    if tiles <= 1 << 16:
                        plans.add(kernel.LutPlan(rt, cg, k_chunk, splits, tiles, staged))
    return sorted(plans)


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("g,m,k,n", [(1, 2, 2048, 256), (1, 17, 300, 77), (3, 5, 1001, 130),
                                     (1, 16, 2048, 16384)])
def test_lut_kernel_every_plan_bitwise(cuda, border, g, m, k, n):
    """The kernel body under plans the wrapper may not pick at this shape:
    both table routes, every row tile, narrow and wide blocks, fine and
    coarse K splits; each run one launch, each bit for bit the plain
    version."""
    a, b = _int8((g, m, k), 8, cuda), _int8((g, k, n), 9, cuda)
    table = ops.kernel_table(border, cuda)
    want = ref.lut_matmul_ref(a, b, lut.table_tensor(border, cuda))
    for plan in _other_plans(g, m, k, n, table.dtype == torch.int16):
        got = kernel.lut_matmul_with_plan(a[0] if g == 1 else a, b[0] if g == 1 else b,
                                          table, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want[0] if g == 1 else want), plan


def test_lut_kernel_row_independent(cuda):
    """Rows 0..1 of an M = 16 call (16-row tiles) are the M = 2 call's (2-row
    tiles) bit for bit, at a decode and a prefill shape of each route."""
    for k, n in ((2048, 16384), (2048, 256), (1024, 32)):
        a, b = _int8((16, k), 10, cuda), _int8((k, n), 11, cuda)
        for border in (8, 14):
            table = ops.kernel_table(border, cuda)
            full = kernel.amr_matmul_int8_lut(a, b, table)
            assert torch.equal(kernel.amr_matmul_int8_lut(a[:2].contiguous(), b, table), full[:2])


# the rank-8 gemma-2b path's dense shapes, and ragged ones: M of 1, 3, 17; N
# off the column tiles and the 4-byte loads; K off the 256-chunks
LOWRANK_SHAPES = [(2, 2048, 256), (5, 1500, 100), (16, 512, 64), (2, 2048, 16384),
                  (2, 16384, 2048), (16, 2048, 2048), (16, 2048, 256), (1, 2048 + 96, 2048),
                  (3, 100, 77), (17, 2048 + 96, 300), (1, 1, 1), (3, 257, 4098)]


@pytest.mark.parametrize("rank", [1, 8, 16])
@pytest.mark.parametrize("m,k,n", LOWRANK_SHAPES)
def test_lowrank_kernel_close(cuda, rank, m, k, n):
    a, b = _int8((m, k), 4, cuda), _int8((k, n), 5, cuda)
    u, v = lut.factor_tensors(8, rank, cuda)
    got = kernel.amr_matmul_int8(a, b, u, v)
    want = ref.lowrank_matmul_ref(a, b, u, v)
    fa, fb = a.float(), b.float()
    # sum_k |a b| + sum_r |u v|: the error lanes of the plain version with |u|, |v|
    scale = (fa.abs() @ fb.abs() + ref.lowrank_matmul_ref(a, b, u.abs(), v.abs()) - fa @ fb).max()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(scale)


@pytest.mark.parametrize("k,n", [(3000, 200), (2048, 16384), (16384, 2048)])
def test_lowrank_kernel_row_independent(cuda, k, n):
    """Each row of an M = 16 call, bit for bit the same row alone (M = 1, 2
    rows a thread) and in other batches (M = 2, 3)."""
    a, b = _int8((16, k), 6, cuda), _int8((k, n), 7, cuda)
    u, v = lut.factor_tensors(8, 8, cuda)
    full = kernel.amr_matmul_int8(a, b, u, v)
    for i in range(16):
        assert torch.equal(kernel.amr_matmul_int8(a[i:i + 1].contiguous(), b, u, v), full[i:i + 1])
    for rows in (slice(3, 5), slice(0, 3), slice(0, 16)):
        assert torch.equal(kernel.amr_matmul_int8(a[rows].contiguous(), b, u, v), full[rows])


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    a, b = _int8((4, 64), 0, cuda), _int8((64, 8), 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.amr_matmul_int8_lut(a, b.t().contiguous().t(), ops.kernel_table(8, cuda))
    u, v = lut.factor_tensors(8, 3, cuda)
    with pytest.raises(ValueError, match="rank"):
        kernel.amr_matmul_int8(a, b, u, v)
    with pytest.raises(ValueError, match="devices"):
        kernel.amr_matmul_int8_lut(a, b.cpu(), ops.kernel_table(8, cuda))


def _idx(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.int32)


# dense shapes of the amr_inject path and ragged ones (M 1, 3; N 24, 70; K 5, 2048 + 7)
REPLAY_SHAPES = [(1, 1, 1), (2, 2048, 256), (3, 100, 77), (16, 2048, 300), (40, 1000, 513),
                 (2, 2048, 16384), (16, 16384, 2048), (1, 5, 24), (3, 2048 + 7, 70),
                 (1, 2048 + 7, 24), (3, 5, 70)]


@pytest.mark.parametrize("border", [6, 8, 14])
@pytest.mark.parametrize("m,k,n", REPLAY_SHAPES)
def test_replay_kernel_bitwise(cuda, border, m, k, n):
    """The replay kernel against its plain version and against the gather
    kernel on the same schedule's table (the same products); border 6 is the
    schedule phase 4 of chip_smoke.py registers as a DSE candidate."""
    inj = engine.get_injector(2, border)
    ia, ib = _idx((1, m, k), 0, cuda), _idx((k, n), 1, cuda)
    before = rkernel.REPLAY.launches
    got = rkernel.inject_replay_int32(inj, ia, ib)
    assert rkernel.REPLAY.launches == before + 1
    want = rref.replay_matmul_ref(inj, ia, ib, max_pairs=1 << 22)
    lut_out = kernel.amr_matmul_int8_lut((ia[0] - 128).to(torch.int8), (ib - 128).to(torch.int8),
                                         ops.kernel_table(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[0], lut_out)


@pytest.mark.parametrize("border", [6, 8, 14])
@pytest.mark.parametrize("g,m,k,n", [(2, 8, 256, 24), (2, 8, 24, 256), (1, 128, 256, 16),
                                     (5, 3, 70, 33), (3, 1, 5, 70), (2, 3, 2048 + 7, 24)])
def test_replay_kernel_grouped_bitwise(cuda, border, g, m, k, n):
    inj = engine.get_injector(2, border)
    ia, ib = _idx((g, m, k), 2, cuda), _idx((g, k, n), 3, cuda)
    got = rkernel.inject_replay_int32(inj, ia, ib)
    want = rref.replay_matmul_ref(inj, ia, ib, max_pairs=1 << 22)
    lut_out = kernel.amr_matmul_int8_lut_grouped((ia - 128).to(torch.int8),
                                                 (ib - 128).to(torch.int8),
                                                 ops.kernel_table(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, lut_out)


@pytest.mark.parametrize("g,m,k,n", [(1, 16, 2048, 2048), (1, 2, 2048, 16384), (1, 3, 5, 70),
                                     (2, 1, 2048 + 7, 24)])
def test_replay_kernel_exact_schedule_is_the_integer_product(cuda, g, m, k, n):
    """border=None replays the exact multiplier: the sums equal the integer
    matmul, computed in float64 (exact below 2**53)."""
    inj = engine.compile_injector(reduction.get_schedule(2, None))
    ia, ib = _idx((g, m, k), 4, cuda), _idx((g, k, n), 5, cuda)
    got = rkernel.inject_replay_int32(inj, ia, ib if g > 1 else ib[0])
    want = (ia - 128).double() @ (ib - 128).double()
    torch.cuda.synchronize()
    assert torch.equal(got.double(), want)


@pytest.fixture
def minterm_programs(monkeypatch):
    """Replay programs lowered as for a build without the exact full
    adder's (sum, carry) pair: its cells run in kGeneric runs, on the
    minterm form of their own truth bytes (the served programs never take
    that form)."""
    fa = (0x96, 0xE8)
    monkeypatch.setattr(rkernel, "_PAIR_INDEX",
                        {p: i for i, p in enumerate(rkernel.CELL_PAIRS) if p != fa})
    rkernel.program_tensors.cache_clear()
    rkernel.launch_plan.cache_clear()
    yield
    monkeypatch.undo()
    rkernel.program_tensors.cache_clear()
    rkernel.launch_plan.cache_clear()


@pytest.mark.parametrize("g,m,k,n,items", [(1, 2, 2048, 2048, rkernel.ITEMS),
                                           (2, 8, 256, 24, 1)])
def test_replay_kernel_minterm_form_bitwise(cuda, minterm_programs, g, m, k, n, items):
    """Cells outside the immediate list give the same integers, with
    kItems items a thread (dense) and with 1 (grouped)."""
    inj = engine.get_injector(2, 8)
    ia, ib = _idx((g, m, k), 6, cuda), _idx((g, k, n) if g > 1 else (k, n), 7, cuda)
    assert rkernel.program_tensors(inj, ia.device)[0].generic_ops > 0
    assert rkernel.launch_plan(inj, ia.device, g, m, n, k, g > 1)[1][-1] == items
    got = rkernel.inject_replay_int32(inj, ia, ib)
    want = rref.replay_matmul_ref(inj, ia, ib, max_pairs=1 << 22)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_attn_fused_inject_kernel_minterm_form_bitwise(cuda, minterm_programs):
    inj = engine.get_injector(2, 8)
    assert rkernel.program_tensors(inj, cuda)[0].generic_ops > 0
    args = _attn_operands(2, 8, 256, 24, 256, 1, cuda, method="inject")
    got = akernel.attn_fused_inject(inj, *args, scale=16.0)
    want = aref.attn_fused_inject_ref(inj, *args, 16.0, max_pairs=1 << 24)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_replay_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    inj = engine.get_injector(2, 8)
    ia, ib = _idx((1, 4, 64), 0, cuda), _idx((64, 8), 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rkernel.inject_replay_int32(inj, ia, ib.t().contiguous().t())
    with pytest.raises(TypeError, match="int32"):
        rkernel.inject_replay_int32(inj, ia.long(), ib)
    with pytest.raises(ValueError, match="devices"):
        rkernel.inject_replay_int32(inj, ia, ib.cpu())


@pytest.mark.parametrize("rank", [0, 8])
def test_reduced_model_serves_through_kernels(cuda, rank):
    """Reduced gemma-2b under amr_kernel: the card's kernels and the CPU's
    plain versions give the same tokens on the same weights."""
    _serve_card_and_cpu(AMRNumerics("amr_kernel", border=8, rank=rank))


def test_reduced_model_serves_through_replay_kernel(cuda):
    before = rkernel.REPLAY.launches
    _serve_card_and_cpu(AMRNumerics("amr_inject", border=8))
    assert rkernel.REPLAY.launches > before


def _ssd_inputs(B, S, H, P, N, G, dtype, device, seed=0, carry_chunk=None):
    """dt as the model makes it (softplus of a projection), or, with
    ``carry_chunk``, scaled per head so that a chunk of that length decays
    the state by exp(-0.5) on average and the carried state shows."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    if carry_chunk:
        dt = torch.rand((B, S, H), generator=g, device=device) / (torch.exp(a_log) * carry_chunk)
    else:
        dt = torch.nn.functional.softplus(normal(B, S, H))
    return (normal(B, S, H, P).to(dtype), dt, a_log, normal(B, S, G, N).to(dtype),
            normal(B, S, G, N).to(dtype))


def _ssd_err_over_bound(args, chunk, split):
    got = skernel.ssd_scan(*args, chunk, split=split)
    want = sref.ssd_ref(*args, chunk, split=split)
    bounds = sref.ssd_error_bound(*args, chunk, split=split)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    return max(float(((g - w).abs() / bd).max()) for g, w, bd in zip(got, want, bounds))


_SSD_CARRY = (1, 1024, 32, 64, 128, 1, 256, torch.bfloat16)  # 4 chunks at the model's widths


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype,carry", [
    (1, 16, 32, 64, 128, 1, 256, torch.bfloat16, False),    # the 16-token prefill, padded tail
    (1, 1024, 32, 64, 128, 1, 256, torch.bfloat16, False),  # 4 chunks, the model's dt
    (2, 300, 8, 32, 64, 2, 128, torch.float32, False),      # G < H, ragged last chunk
    (1, 37, 4, 16, 16, 4, 16, torch.float32, False),        # the reduced config's widths
    _SSD_CARRY + (True,),                                   # 4 chunks, the state carried
    (2, 300, 8, 32, 64, 2, 128, torch.float32, True),       # G < H, ragged, carried
    (1, 2048, 32, 64, 128, 1, 256, torch.bfloat16, False),  # 8 chunks: more blocks than SMs
    (1, 2048, 32, 64, 128, 1, 256, torch.bfloat16, True),   # the same, carried
    (1, 512, 8, 64, 128, 1, 128, torch.float32, True),      # P split (16 columns), 4 chunks
    (3, 1000, 5, 48, 32, 5, 256, torch.float32, True),      # P split of 48, ragged, B > 1
])
def test_ssd_kernel_within_bound_of_plain(cuda, split, B, S, H, P, N, G, chunk, dtype, carry):
    args = _ssd_inputs(B, S, H, P, N, G, dtype, cuda, carry_chunk=chunk if carry else None)
    before = skernel.SSD.launches
    ratio = _ssd_err_over_bound(args, chunk, split)
    assert skernel.SSD.launches == before + 1
    assert ratio <= 1.0, ratio
    if carry:  # a kernel without the carry would be off by the carried part
        bounds = sref.ssd_error_bound(*args, chunk, split=split)
        carried = sref.ssd_carried(*args, chunk, split=split)
        seen = [float((cr.abs() / bd).max()) for cr, bd in zip(carried, bounds)]
        assert min(seen[1:] if split else seen) >= 100.0, seen


# Faults planted in a copy of the kernel's source: the carried state dropped
# or mis-scaled, and reduced precision where TF32 or bf16 would round.
_TF32 = ("__device__ __forceinline__ float tf32(float v) {\n"
         "  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);\n}\n")
_BF16 = ("__device__ __forceinline__ float bf16(float v) {\n"
         "  return __bfloat162float(__float2bfloat16(v));\n}\n")
_DECAY = "acc[i][j] * expf(s_cum[tg] - s_cum[sg])"
_XDT = "widen(x[xrow + pc]) * s_dt[s]"
SSD_PLANTS = {
    "drop_carry": ("hn[j] = decay_q * hcv[j] + cacc[r][i][j];", "hn[j] = cacc[r][i][j];"),
    "half_decay": ("const float decay_q = expf(cum_q);",
                   "const float decay_q = expf(0.5f * cum_q);"),
    "tf32_xdt": (_XDT, f"tf32({_XDT})"),
    "tf32_decay": (_DECAY, "acc[i][j] * tf32(expf(s_cum[tg] - s_cum[sg]))"),
    "bf16_decay": (_DECAY, "acc[i][j] * bf16(expf(s_cum[tg] - s_cum[sg]))"),
}


@pytest.fixture(scope="module")
def ssd_plants(tmp_path_factory):
    """One library per planted fault, all built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = skernel.LIBRARY.source.read_text()
    root = tmp_path_factory.mktemp("ssd_plants")
    libs = {}
    for name, (old, new) in SSD_PLANTS.items():
        assert src.count(old) == 1, name
        path = root / f"ssd_scan_{name}.cu"
        path.write_text(src.replace("namespace {\n", "namespace {\n" + _TF32 + _BF16, 1)
                        .replace(old, new))
        libs[name] = CudaLibrary(path)
    with pytest.MonkeyPatch.context() as mp:  # the planted libraries stay out of the checkout
        mp.setattr(build, "BUILD_DIR", root)
        build_all(list(libs.values()))
        for lib in libs.values():
            lib.handle()
    return libs


@pytest.mark.parametrize("plant", list(SSD_PLANTS))
def test_ssd_check_fails_a_planted_fault(cuda, ssd_plants, monkeypatch, capsys, plant):
    """The check above, on inputs whose carried state shows, rejects each
    planted fault in both modes.  With the model's dt, float32's own
    rounding of a cumulative log decay near 3300 is as coarse as TF32's,
    so only such inputs tell a reduced-precision kernel apart."""
    B, S, H, P, N, G, chunk, dtype = _SSD_CARRY
    args = _ssd_inputs(B, S, H, P, N, G, dtype, cuda, carry_chunk=chunk)
    monkeypatch.setattr(skernel, "SSD", CudaKernel("ssd_scan", ssd_plants[plant], "ssd_scan",
                                                   skernel.SSD.argtypes))
    ratios = [_ssd_err_over_bound(args, chunk, split) for split in (False, True)]
    with capsys.disabled():
        print(f"\n[plant] {plant}: err/bound full {ratios[0]:.4g} split {ratios[1]:.4g}")
    assert min(ratios) > 1.0, ratios


def test_ssd_kernel_repeats_bit_for_bit(cuda):
    """The kernel leaves its ticket and chain counters zero: calls of other
    shapes and modes in between, the same call gives the same bits (each
    output is summed in a fixed order), also on a b that starts off a
    16-byte boundary; the wrapper's plan matches the source's shared
    memory."""
    first = _ssd_inputs(1, 2048, 32, 64, 128, 1, torch.bfloat16, cuda, carry_chunk=256)
    other = _ssd_inputs(2, 300, 8, 32, 64, 2, torch.float32, cuda, carry_chunk=128)
    want = skernel.ssd_scan(*first, 256, split=True)
    for _ in range(3):
        skernel.ssd_scan(*other, 128)
        skernel.ssd_scan(*other, 128, split=True)
        got = skernel.ssd_scan(*first, 256, split=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # b at an offset of one element: the wrapper copies it to an aligned buffer
    x, dt, a_log, b, c = first
    shifted = torch.empty(b.numel() + 1, dtype=b.dtype, device=cuda)[1:].view(b.shape)
    shifted.copy_(b)
    got = skernel.ssd_scan(x, dt, a_log, shifted, c, 256, split=True)
    torch.cuda.synchronize()
    assert shifted.data_ptr() % 16 and all(torch.equal(g, w) for g, w in zip(got, want))
    fn = skernel.LIBRARY.handle().ssd_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for n, q, pb in ((128, 256, 64), (16, 16, 16), (64, 128, 32)):
        assert fn(n, q, pb) == skernel.ssd_smem_bytes(n, q, pb)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, a_log, b, c = _ssd_inputs(1, 8, 2, 24, 16, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="P % 16"):
        skernel.ssd_scan(x, dt, a_log, b, c, 16)
    x, dt, a_log, b, c = _ssd_inputs(1, 8, 2, 16, 16, 1, torch.float32, cuda)
    with pytest.raises(TypeError, match="share"):
        skernel.ssd_scan(x.half(), dt, a_log, b, c, 16)
    with pytest.raises(ValueError, match="devices"):
        skernel.ssd_scan(x, dt.cpu(), a_log, b, c, 16)


@pytest.mark.parametrize("numerics", [AMRNumerics("exact"),
                                      AMRNumerics("amr_kernel", border=8, rank=0)],
                         ids=["exact", "amr_kernel-r0"])
def test_reduced_mamba_serves_through_ssd_kernel(cuda, numerics):
    """Reduced mamba2-370m: the card's SSD kernel (full mode under exact,
    split mode under amr_kernel) and the CPU's plain version give the same
    tokens on the same weights."""
    before = skernel.SSD.launches
    _serve_card_and_cpu(numerics, mamba2_370m.reduced())
    assert skernel.SSD.launches > before


def _serve_card_and_cpu(numerics, base=None):
    cfg = dataclasses.replace(base or reduced(), dtype="float32", numerics=numerics)
    params = init_params(cfg, 0, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ServeEngine(cfg, p, n_slots=2, capacity=24, device=dev)
        for prompt in [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2)]:
            eng.submit(Request(prompt=prompt, max_new_tokens=4))
        outs[dev] = [c.tokens for c in eng.run()]
    assert outs["cuda"] == outs["cpu"]


def _attn_operands(G, M, D, T, P, seed, device, method="lut", causal=False):
    """Quantized operands of normal q, kt, v and a ragged (or causal) mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = [torch.randn(shape, generator=g, device=device)
         for shape in ((G, M, D), (G, D, T), (G, T, P))]
    if causal:
        mask = torch.tril(torch.ones(M, T, dtype=torch.int32, device=device)).expand(G, M, T)
    else:
        lengths = torch.randint(1, T + 1, (G, M, 1), generator=g, device=device)
        mask = (torch.arange(T, device=device) < lengths).int()
    return (*aops.quantize_operands(*x, method), mask.contiguous())


ATTN_SHAPES = [(2, 8, 256, 24, 256, False), (1, 128, 256, 16, 256, True),
               (2, 8, 256, 8192, 256, False), (1, 256, 256, 256, 256, True),
               (3, 6, 40, 70, 33, False), (1, 64, 16, 1000, 24, False)]


def _row_tiles(M):
    return [None] + [b for b in (1, 2, 8, 16) if M % b == 0]


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("G,M,D,T,P,causal", ATTN_SHAPES)
def test_attn_fused_lut_kernel_bitwise(cuda, border, G, M, D, T, P, causal):
    args = _attn_operands(G, M, D, T, P, 0, cuda, causal=causal)
    table = ops.kernel_table(border, cuda)
    want = aref.attn_fused_lut_ref(*args, lut.table_tensor(border, cuda), 16.0)
    for bm in _row_tiles(M):
        before = akernel.LUT.launches
        got = akernel.attn_fused_lut(*args, table, scale=16.0, bm=bm)
        assert akernel.LUT.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bm, float((got - want).abs().max()))


@pytest.mark.parametrize("schedule", [8, 14, "dse6"])
@pytest.mark.parametrize("G,M,D,T,P,causal", [s for s in ATTN_SHAPES if s[3] * s[1] < 10**6])
def test_attn_fused_inject_kernel_bitwise(cuda, schedule, G, M, D, T, P, causal):
    if schedule == "dse6":
        handle = injection.register_schedule(reduction.get_schedule(2, 6), name="cuda:attn-b6")
        inj = injection.get_injector(AMRNumerics("amr_inject", border=6, schedule_ref=handle))
    else:
        inj = engine.get_injector(2, schedule)
    args = _attn_operands(G, M, D, T, P, 1, cuda, method="inject", causal=causal)
    want = aref.attn_fused_inject_ref(inj, *args, 16.0, max_pairs=1 << 24)
    for bm in _row_tiles(M):
        before = akernel.INJECT.launches
        got = akernel.attn_fused_inject(inj, *args, scale=16.0, bm=bm)
        assert akernel.INJECT.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bm, float((got - want).abs().max()))


def _inject_plans(inj, G, M, D, T, P, device):
    """The wrapper's plan for each row tile and, for each, T slices of 1,
    2 and 3 words and of all of T (there also a block taking the whole
    tile), with 1 and ITEMS k values a thread."""
    prog = rkernel.program_tensors(inj, device)[0]
    n_words = math.ceil(T / 32)
    plans = []
    for bm in _row_tiles(M)[1:]:
        base = akernel.inject_launch_plan(G, M, D, T, P, bm, 132, prog.n_slots, prog.n_opbits,
                                          prog.ops.shape[0])
        plans.append(base)
        for words in sorted({1, 2, 3, n_words} & set(range(1, n_words + 1))):
            for items in (1, rkernel.ITEMS):
                for whole in {False, words == n_words}:
                    qk_wpb, qk_rpb, _ = rkernel.block_shape(min(bm, 16), words)
                    plans.append(base._replace(
                        slice_words=words, slices=math.ceil(n_words / words), qk_wpb=qk_wpb,
                        qk_rpb=qk_rpb, items=items, whole=whole))
    return plans


@pytest.mark.parametrize("G,M,D,T,P", [(2, 8, 256, 1000, 256), (1, 16, 64, 300, 40),
                                       (2, 4, 32, 33, 8)])
def test_attn_fused_inject_every_t_split_bitwise(cuda, G, M, D, T, P):
    """Every row tile and T split, with 1 and ITEMS k values a thread: bit
    for bit the plain version.  T is not a multiple of a word (nor of the
    slices); one row is fully masked, and a slice of T (words 1-2) is
    masked in every other row."""
    inj = engine.get_injector(2, 8)
    q8, k8, v8, sq, sk, sv, mask = _attn_operands(G, M, D, T, P, 5, cuda, method="inject")
    mask = mask.clone()
    mask[0, 1] = 0
    mask[:, ::2, 32:96] = 0
    args = (q8, k8, v8, sq, sk, sv, mask)
    want = aref.attn_fused_inject_ref(inj, *args, 16.0, max_pairs=1 << 24)
    for plan in _inject_plans(inj, G, M, D, T, P, cuda):
        before = akernel.INJECT.launches
        got = akernel.attn_fused_inject_with_plan(inj, *args, scale=16.0, plan=plan)
        torch.cuda.synchronize()
        assert akernel.INJECT.launches == before + 1
        assert torch.equal(got, want), (plan, float((got - want).abs().max()))


def test_attn_fused_inject_takes_a_long_t(cuda):
    """The scores live in device memory, not in a block's shared memory:
    T = 60,000 runs, bit for bit."""
    inj = engine.get_injector(2, 8)
    args = _attn_operands(1, 2, 16, 60000, 8, 3, cuda, method="inject")
    want = aref.attn_fused_inject_ref(inj, *args, 4.0, max_pairs=1 << 24)
    got = akernel.attn_fused_inject(inj, *args, scale=4.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _lut_attn_plans(G, M, D, T, P, int16):
    """The wrapper's plan for each row tile (up to 32 rows: two sub-tiles of
    16) and, for each, T slices of 1, 2 and 3 words and of all of T (there
    also a block taking the whole tile, where it fits), with the table
    staged (int16 only) and through L1."""
    n_words = math.ceil(T / 32)
    plans = []
    for bm in (b for b in (1, 2, 8, 16, 32) if M % b == 0):
        plans.append(akernel.lut_attn_launch_plan(G, M, D, T, P, bm, 132, int16))
        for words in sorted({1, 2, 3, n_words} & set(range(1, n_words + 1))):
            for staged in {False, int16}:
                for whole in {False, words == n_words}:
                    plan = akernel.lut_attn_plan(G, M, D, T, P, bm, 132, slice_words=words,
                                                 staged=staged, whole=whole)
                    if plan.smem <= akernel.SMEM_LIMIT:
                        plans.append(plan)
    return plans


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("G,M,D,T,P", [(2, 8, 256, 1000, 256), (1, 16, 64, 300, 40),
                                       (2, 4, 32, 33, 8), (1, 32, 32, 200, 16)])
def test_attn_fused_lut_every_t_split_bitwise(cuda, border, G, M, D, T, P):
    """Every row tile and T split, whole and split, the table staged and
    through L1 (border 8; border 14's int32 table through L1 only): bit for
    bit the plain version, one launch a call.  T is not a multiple of a word
    (nor of the slices); one row is fully masked, a slice of T (words 1-2)
    is masked in every other row, and columns 128-191 in every row of the
    last group, so that QK^T tiles skip their gathers."""
    q8, k8, v8, sq, sk, sv, mask = _attn_operands(G, M, D, T, P, 6, cuda)
    mask = mask.clone()
    mask[0, 1] = 0
    mask[:, ::2, 32:96] = 0
    mask[-1, :, 128:192] = 0
    args = (q8, k8, v8, sq, sk, sv, mask)
    table = ops.kernel_table(border, cuda)
    want = aref.attn_fused_lut_ref(*args, lut.table_tensor(border, cuda), 16.0)
    plans = _lut_attn_plans(G, M, D, T, P, table.dtype == torch.int16)
    assert {p.whole for p in plans} == {False, True} and len({p.slices for p in plans}) > 1
    assert {p.staged for p in plans} == {False, table.dtype == torch.int16}
    for plan in plans:
        before = akernel.LUT.launches
        got = akernel.attn_fused_lut_with_plan(*args, table, scale=16.0, plan=plan)
        torch.cuda.synchronize()
        assert akernel.LUT.launches == before + 1
        assert torch.equal(got, want), (plan, float((got - want).abs().max()))


def test_attn_fused_lut_takes_a_long_t(cuda):
    """The scores live in device memory, not in a block's shared memory:
    T = 60,000 runs, bit for bit, at border 8 and 14."""
    args = _attn_operands(1, 2, 16, 60000, 8, 3, cuda)
    for border in (8, 14):
        table = ops.kernel_table(border, cuda)
        want = aref.attn_fused_lut_ref(*args, lut.table_tensor(border, cuda), 4.0)
        got = akernel.attn_fused_lut(*args, table, scale=4.0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), border


@pytest.mark.parametrize("method", ["lut", "inject"])
def test_attn_fused_op_within_tolerance_of_the_seam(cuda, method):
    """One op call, one launch; within the flip tolerance of the unfused
    seam composition (torch.softmax) on the card."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, kt, v = (torch.randn(s, generator=g, device=cuda)
                for s in ((2, 8, 256), (2, 256, 1000), (2, 1000, 256)))
    mask = torch.arange(1000, device=cuda) < torch.tensor([[[700]], [[1000]]], device=cuda)
    kern = akernel.LUT if method == "lut" else akernel.INJECT
    before = kern.launches
    out = aops.fused_attention(q, kt, v, mask.expand(2, 8, 1000), method=method)
    assert kern.launches == before + 1
    want = aops.fused_attention_reference(q, kt, v, mask.expand(2, 8, 1000), method=method)
    q8, k8, v8, sq, sk, sv = aops.quantize_operands(q, kt, v, method)
    table = lut.table_tensor(8, cuda)
    qp, ps = aref.softmax_requant(ref.lut_matmul_ref(q8, k8, table), sq, sk,
                                  mask.expand(2, 8, 1000).int(), 16.0)
    rqp, rps = quantize_int8(aops.reference_probabilities(q, kt, mask.expand(2, 8, 1000),
                                                          method=method), axis=-1)
    torch.cuda.synchronize()
    assert int((qp.int() - rqp.int()).abs().max()) <= 1
    assert float((qp != rqp).float().mean()) <= 0.01
    tol = aref.flip_tolerance(qp, rqp, ps, rps, sv, aref.index_step(table), want)
    assert bool(((out - want).abs() <= tol).all())


def test_attn_fused_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q8, k8, v8, sq, sk, sv, mask = _attn_operands(1, 4, 16, 8, 8, 3, cuda)
    table = ops.kernel_table(8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        akernel.attn_fused_lut(q8, k8.transpose(1, 2).contiguous().transpose(1, 2), v8, sq, sk,
                               sv, mask, table, scale=4.0)
    with pytest.raises(ValueError, match="devices"):
        akernel.attn_fused_lut(q8, k8, v8, sq, sk, sv, mask.cpu(), table, scale=4.0)


# planted faults in copies of the LUT kernel's softmax (attn_softmax.cuh):
# the bitwise check must see each of them
ATTN_PLANTS = {
    "fast_exp": ("const float e = expf(", "const float e = __expf("),
    "sum_order": ("for (int o = 16; o > 0; o >>= 1) sum =", "for (int o = 1; o < 32; o <<= 1) sum ="),
    # ps = amax * (1 / 127), what PyTorch runs on the card for a division
    # by a Python number
    "reciprocal_scale": ("__fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)",
                         "__fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f)"),
}


@pytest.fixture(scope="module")
def attn_plants(tmp_path_factory):
    """One copy of attn_fused_lut.cu with every header of its library per
    fault, the fault planted in the softmax header."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = akernel.LUT_LIBRARY.source.read_text()
    headers = {h.name: h.read_text() for h in akernel.LUT_LIBRARY.headers}
    softmax = "attn_softmax.cuh"
    root = tmp_path_factory.mktemp("attn_plants")
    libs = {}
    for name, (old, new) in ATTN_PLANTS.items():
        assert headers[softmax].count(old) == 1, name
        (root / name).mkdir()
        for hname, text in headers.items():
            (root / name / hname).write_text(text.replace(old, new) if hname == softmax else text)
        (root / name / "attn_fused_lut.cu").write_text(src)
        libs[name] = CudaLibrary(root / name / "attn_fused_lut.cu",
                                 tuple(root / name / h for h in headers))
    with pytest.MonkeyPatch.context() as mp:  # the planted libraries stay out of the checkout
        mp.setattr(build, "BUILD_DIR", root)
        build_all(list(libs.values()))
        for lib in libs.values():
            lib.handle()
    return libs


@pytest.mark.parametrize("plant", list(ATTN_PLANTS))
def test_attn_fused_check_fails_a_planted_fault(cuda, attn_plants, monkeypatch, capsys, plant):
    """128 rows over gemma-2b's 8192-token context: a planted fault changes bits."""
    args = _attn_operands(2, 64, 256, 8192, 256, 4, cuda)
    table = ops.kernel_table(8, cuda)
    want = aref.attn_fused_lut_ref(*args, lut.table_tensor(8, cuda), 16.0)
    assert torch.equal(akernel.attn_fused_lut(*args, table, scale=16.0), want)
    monkeypatch.setattr(akernel, "LUT", CudaKernel("attn_fused_lut", attn_plants[plant],
                                                   "attn_fused_lut", akernel.LUT.argtypes))
    got = akernel.attn_fused_lut(*args, table, scale=16.0)
    torch.cuda.synchronize()
    differ = float((got != want).float().mean())
    with capsys.disabled():
        print(f"\n[plant] {plant}: {differ:.4f} of the outputs differ, max |diff| "
              f"{float((got - want).abs().max()):.3g}")
    assert differ > 0.0
