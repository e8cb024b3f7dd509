"""The port's AMR matmul (plain versions, ops and numerics seam) against the
JAX package's Pallas kernels, run as the JAX package's own tests run them
(``interpret=True`` on the CPU).

Tolerances:
* the integer gather results are compared bit for bit;
* the low-rank float32 result sums the same products in another order:
  |port - jax| <= 1e-6 * max_mn sum_k (|a b| + sum_r |u v|);
* float ops rescale the same int32 sums by the same scales, but XLA compiles
  ``acc * sa * sb`` in its own order: |port - jax| <= 4 float32 ulps of the
  largest |output| (and the low-rank ops add the bound above, rescaled).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lut as jlut
from repro.kernels.amr_matmul import kernel as jkernel
from repro.kernels.amr_matmul import ops as jops
from repro_torch.core import lut as tlut
from repro_torch.kernels.amr_matmul import kernel as tkernel
from repro_torch.kernels.amr_matmul import ops as tops

# the packages re-export the function ``approx_matmul``, which shadows the module
japprox = importlib.import_module("repro.numerics.approx_matmul")
tapprox = importlib.import_module("repro_torch.numerics.approx_matmul")
CPU = torch.device("cpu")
ULP = 2.0 ** -23


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def _float(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_float_close(got, ref, extra=0.0):
    ref = np.asarray(ref)
    tol = 4 * ULP * float(np.abs(ref).max()) + extra
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol


# ------------------------------------------------------------ int kernels
@pytest.mark.parametrize("border", [8, 14])
@pytest.mark.parametrize("m,k,n,tiles", [(16, 64, 32, (8, 16, 32)), (8, 256, 24, (8, 8, 64))])
def test_lut_matmul_bitwise(border, m, k, n, tiles):
    a, b = _int8((m, k), 0), _int8((k, n), 1)
    bm, bn, bk = tiles
    ref = np.asarray(jkernel.amr_matmul_int8_lut(
        jnp.asarray(a), jnp.asarray(b), jlut.table_array(border, engine="numpy"),
        bm=bm, bn=bn, bk=bk, interpret=True))
    got = tkernel.amr_matmul_int8_lut(_t(a), _t(b), tlut.table_tensor(border, CPU))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    narrow = tops.kernel_table(border, CPU)
    assert narrow.dtype == (torch.int16 if border == 8 else torch.int32)
    np.testing.assert_array_equal(tkernel.amr_matmul_int8_lut(_t(a), _t(b), narrow).numpy(), ref)


@pytest.mark.parametrize("border", [8, 14])
def test_lut_grouped_bitwise(border):
    g, m, k, n = 3, 8, 32, 16
    a, b = _int8((g, m, k), 2), _int8((g, k, n), 3)
    ref = np.asarray(jkernel._amr_matmul_int8_lut_grouped_jit(
        jnp.asarray(a), jnp.asarray(b), jlut.table_array(border, engine="numpy"),
        bm=8, bn=16, bk=16, interpret=True))
    got = tkernel.amr_matmul_int8_lut_grouped(_t(a), _t(b), tops.kernel_table(border, CPU))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rank", [1, 8])
def test_lowrank_matmul_close(rank):
    m, k, n = 16, 128, 32
    a, b = _int8((m, k), 4), _int8((k, n), 5)
    f = tlut.lowrank_factor(8, rank)
    ref = np.asarray(jkernel.amr_matmul_int8(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(f.u), jnp.asarray(f.v),
        bm=8, bn=16, bk=32, interpret=True))
    got = tkernel.amr_matmul_int8(_t(a), _t(b), _t(f.u), _t(f.v)).numpy()
    ua, vb = np.abs(f.u[a.astype(int) + 128]), np.abs(f.v[b.astype(int) + 128])
    scale = (np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
             + np.einsum("mkr,knr->mn", ua, vb)).max()
    assert float(np.abs(got - ref).max()) <= 1e-6 * scale


def test_wrappers_reject_bad_operands():
    a, b = _t(_int8((4, 8), 0)), _t(_int8((8, 4), 1))
    table = tlut.table_tensor(8, CPU)
    with pytest.raises(TypeError):
        tkernel.amr_matmul_int8_lut(a.float(), b, table)
    with pytest.raises(ValueError):
        tkernel.amr_matmul_int8_lut(a, b[:4], table)
    with pytest.raises(ValueError):
        tkernel.amr_matmul_int8_lut_grouped(a[None], b[None].expand(2, 8, 4), table)


def test_cpu_tensors_take_the_plain_version():
    before = [k.launches for k in tkernel.KERNELS]
    a, b = _t(_int8((4, 8), 0)), _t(_int8((8, 4), 1))
    tkernel.amr_matmul_int8_lut(a, b, tlut.table_tensor(8, CPU))
    u, v = tlut.factor_tensors(8, 8, CPU)
    tkernel.amr_matmul_int8(a, b, u, v)
    assert [k.launches for k in tkernel.KERNELS] == before


# ---------------------------------------------------------------- float ops
@pytest.mark.parametrize("method", ["lut", "lowrank"])
def test_amr_matmul_op(method):
    a, b = _float((24, 64), 6), _float((64, 40), 7)
    ref = jops.amr_matmul(jnp.asarray(a), jnp.asarray(b), border=8, rank=8, method=method)
    got = tops.amr_matmul(_t(a), _t(b), border=8, rank=8, method=method).numpy()
    _assert_float_close(got, ref, extra=1e-5 * float(np.abs(np.asarray(ref)).max()))


def test_amr_matmul_grouped_op():
    a, b = _float((4, 8, 32), 8), _float((4, 32, 16), 9)
    ref = jops.amr_matmul_grouped(jnp.asarray(a), jnp.asarray(b), border=8)
    got = tops.amr_matmul_grouped(_t(a), _t(b), border=8).numpy()
    _assert_float_close(got, ref)


@pytest.mark.parametrize("rank", [0, 8])
@pytest.mark.parametrize("batched", [False, True], ids=["weight", "batched"])
def test_matmul_amr_kernel(rank, batched):
    a = _float((2, 3, 8, 32), 10)
    b = _float((2, 3, 32, 12), 11) if batched else _float((32, 12), 11)
    ref = japprox.matmul_amr_kernel(jnp.asarray(a), jnp.asarray(b), 8, rank)
    got = tapprox.matmul_amr_kernel(_t(a), _t(b), 8, rank).numpy()
    _assert_float_close(got, ref, extra=1e-5 * float(np.abs(np.asarray(ref)).max()))


def test_amr_lut_oracle_matches_and_kernel_rank0_equals_oracle_sums():
    a, b = _float((3, 8, 32), 12), _float((32, 12), 13)
    ref = japprox.matmul_amr_lut(jnp.asarray(a), jnp.asarray(b), 8)
    got = tapprox.matmul_amr_lut(_t(a), _t(b), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the rank-0 kernel path rescales the same integer sums in the same order
    np.testing.assert_array_equal(tapprox.matmul_amr_kernel(_t(a), _t(b), 8, 0).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("k,raises", [(54252, True), (54251, False)])
def test_saturation_guard_raises_where_jax_does(k, raises):
    """border 14: max|product| = 39584, so K = 54252 reaches 2**31."""
    a, b = np.ones((1, k), np.float32), np.ones((k, 1), np.float32)
    if raises:
        with pytest.raises(ValueError, match="saturate"):
            japprox.matmul_amr_lut(jnp.asarray(a), jnp.asarray(b), 14)
        with pytest.raises(ValueError, match="saturate"):
            tapprox.matmul_amr_lut(_t(a), _t(b), 14)
        with pytest.raises(ValueError, match="saturate"):
            tops.amr_matmul(_t(a), _t(b), border=14, method="lut")
    else:
        ref = japprox.matmul_amr_lut(jnp.asarray(a), jnp.asarray(b), 14)
        np.testing.assert_array_equal(tapprox.matmul_amr_lut(_t(a), _t(b), 14).numpy(),
                                      np.asarray(ref))


def test_unported_modes_refused():
    """Every mode of the JAX package is ported now: the registry names them
    all, and only a name it does not know is refused."""
    assert tapprox.registry.mode_names() == japprox.registry.mode_names()
    for mode in tapprox.registry.mode_names():
        assert tapprox.AMRNumerics(mode).mode == japprox.AMRNumerics(mode).mode
    with pytest.raises(ValueError):
        tapprox.AMRNumerics("bogus")
    with pytest.raises(ValueError):
        tapprox.AMRNumerics("amr_kernel", rank=-1)
    assert tapprox.AMRNumerics("exact").is_exact()
    assert not tapprox.AMRNumerics("amr_kernel", rank=0).is_exact()


def test_cuda_library_is_keyed_by_its_source(tmp_path):
    """A library is named by a hash of its source and flags, so an edited
    source is rebuilt rather than loaded stale."""
    from repro_torch.kernels.build import BUILD_DIR, CudaLibrary

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    lib = CudaLibrary(src)
    first = lib.path
    assert first.parent == BUILD_DIR and first.name.startswith("k-") and first.suffix == ".so"
    src.write_text("// two\n")
    assert lib.path != first
    assert all(shipped.source.is_file() for shipped in tkernel.LIBRARIES)


# ------------------------------------------- independence of the batch
def test_exact_matmul_is_one_call_per_request(monkeypatch):
    """A 2-D weight takes one ``torch.matmul`` per slice of A's leading
    (request) dim: a decode step of 3 requests is 3 calls of the shape a
    solo request makes, and a one-request prefill stays one call."""
    a, w = _t(_float((3, 5, 24), 1)), _t(_float((24, 40), 2))
    want = torch.stack([torch.matmul(a[i].clone(), w) for i in range(3)])
    calls = []
    real = torch.matmul

    def counting(x, y):
        calls.append(tuple(x.shape))
        return real(x, y)

    monkeypatch.setattr(torch, "matmul", counting)
    got = tapprox.matmul_exact(a, w)
    assert calls == [(5, 24)] * 3
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    calls.clear()
    tapprox.matmul_exact(a[:1], w)
    assert calls == [(5, 24)]
    calls.clear()
    tapprox.matmul_exact(a[0], w)
    assert calls == [(5, 24)]


def test_lowrank_plain_version_is_row_independent(monkeypatch):
    """Each row of the plain low-rank product equals that row computed
    alone, bit for bit, with K split into several chunks."""
    from repro_torch.kernels.amr_matmul import ref as tref

    monkeypatch.setattr(tref, "_MAX_ELEMS", 1 << 10)  # 4 k per chunk at N=32, r=8
    a, b = _int8((7, 40), 3), _int8((40, 32), 4)
    f = tlut.lowrank_factor(8, 8)
    u, v = _t(f.u), _t(f.v)
    batched = tref.lowrank_matmul_ref(_t(a), _t(b), u, v)
    for i in range(a.shape[0]):
        np.testing.assert_array_equal(
            batched[i:i + 1].numpy(), tref.lowrank_matmul_ref(_t(a[i:i + 1]), _t(b), u, v).numpy())
