"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
no CUDA device is present (this is decided when the test runs, never at
import).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: the integer gather kernels and the circuit-replay kernel are
compared bit for bit (also at border 14, whose products exceed int16); the
low-rank kernel sums the same float32 terms as its plain version in another
order: |kernel - plain| <= 1e-5 * max_mn sum_k (|a b| + sum_r |u v|).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.gemma_2b import reduced
from repro_torch.core import lut
from repro_torch.core import engine, reduction
from repro_torch.kernels.amr_matmul import kernel, ops, ref
from repro_torch.kernels.build import build_all
from repro_torch.kernels.inject_replay import kernel as rkernel
from repro_torch.kernels.inject_replay import ref as rref
from repro_torch.models import init_params
from repro_torch.models.tree import tree_map
from repro_torch.numerics import AMRNumerics
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
    records = build_all(list(kernel.LIBRARIES) + list(rkernel.LIBRARIES))
    with capsys.disabled():
        for name, rec in records.items():
            print(f"\n[build] {name}: {rec.seconds:.1f}s\n{rec.log}")


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (2, 2048, 256), (3, 100, 77), (16, 2048, 300),
                                   (40, 1000, 513)])
def test_lut_kernel_bitwise(cuda, border, m, k, n):
    a, b = _int8((m, k), 0, cuda), _int8((k, n), 1, cuda)
    table = ops.kernel_table(border, cuda)
    before = kernel.LUT.launches
    got = kernel.amr_matmul_int8_lut(a, b, table)
    assert kernel.LUT.launches == before + 1
    want = ref.lut_matmul_ref(a, b, lut.table_tensor(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("g,m,k,n", [(2, 8, 256, 24), (2, 8, 24, 256), (1, 128, 256, 16),
                                     (5, 3, 70, 33)])
def test_lut_grouped_kernel_bitwise(cuda, border, g, m, k, n):
    a, b = _int8((g, m, k), 2, cuda), _int8((g, k, n), 3, cuda)
    got = kernel.amr_matmul_int8_lut_grouped(a, b, ops.kernel_table(border, cuda))
    want = ref.lut_matmul_ref(a, b, lut.table_tensor(border, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rank", [1, 8, 16])
@pytest.mark.parametrize("m,k,n", [(2, 2048, 256), (5, 1500, 100), (16, 512, 64)])
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


def test_lowrank_kernel_row_independent(cuda):
    a, b = _int8((16, 3000), 6, cuda), _int8((3000, 200), 7, cuda)
    u, v = lut.factor_tensors(8, 8, cuda)
    full = kernel.amr_matmul_int8(a, b, u, v)
    for rows in (slice(0, 1), slice(3, 5), slice(0, 16)):
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


@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (2, 2048, 256), (3, 100, 77), (16, 2048, 300),
                                   (40, 1000, 513)])
def test_replay_kernel_bitwise(cuda, border, m, k, n):
    """The replay kernel against its plain version and against the gather
    kernel on the same schedule's table (the same products)."""
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


@pytest.mark.parametrize("g,m,k,n", [(2, 8, 256, 24), (2, 8, 24, 256), (1, 128, 256, 16),
                                     (5, 3, 70, 33)])
def test_replay_kernel_grouped_bitwise(cuda, g, m, k, n):
    inj = engine.get_injector(2, 8)
    ia, ib = _idx((g, m, k), 2, cuda), _idx((g, k, n), 3, cuda)
    got = rkernel.inject_replay_int32(inj, ia, ib)
    want = rref.replay_matmul_ref(inj, ia, ib, max_pairs=1 << 22)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_replay_kernel_exact_schedule_is_the_integer_product(cuda):
    """border=None replays the exact multiplier: the sums equal the integer
    matmul, computed in float64 (exact below 2**53)."""
    inj = engine.compile_injector(reduction.get_schedule(2, None))
    ia, ib = _idx((1, 16, 2048), 4, cuda), _idx((2048, 2048), 5, cuda)
    got = rkernel.inject_replay_int32(inj, ia, ib)
    want = (ia[0] - 128).double() @ (ib - 128).double()
    torch.cuda.synchronize()
    assert torch.equal(got[0].double(), want)


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


def _serve_card_and_cpu(numerics):
    cfg = dataclasses.replace(reduced(), dtype="float32", numerics=numerics)
    params = init_params(cfg, 0, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ServeEngine(cfg, p, n_slots=2, capacity=24, device=dev)
        for prompt in [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2)]:
            eng.submit(Request(prompt=prompt, max_new_tokens=4))
        outs[dev] = [c.tokens for c in eng.run()]
    assert outs["cuda"] == outs["cpu"]
