"""The port's RMSNorm and its row mean-square kernel (``kernels.rms_norm``).

On the CPU: ``mean_square`` is its plain version, ``rms_norm`` matches the
JAX package's at 1e-6 (its float32 sum against the port's float64 one), the
autograd backward of the kernel's route gives the bits autograd gives the
plain version, and a row's mean square does not depend on the rows with it.

Marked ``cuda`` (skip without a GPU): the kernel against its plain version
within one float32 ulp (both sum the exact float64 squares in float64,
within d 2^-53 of the exact sum, and round once to float32: equal but
where the sums straddle a rounding boundary), a row's bits the same in
batches of 1 to 64 rows, one launch a call, a view that is not 16-byte
aligned, the backward's bits, and its refusals.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_intra_op_thread  # noqa: F401

from repro_torch.kernels.rms_norm import kernel as nkernel
from repro_torch.kernels.rms_norm.ref import mean_square_ref
from repro_torch.models.layers import rms_norm

# (rows, d): whisper-small's and gemma-2b's widths, a head dim, internvl2-76b's
# width, an odd width (the kernel's scalar path) and a single row
SHAPES = [(6, 768), (5, 2048), (33, 64), (3, 8192), (7, 37), (1, 256)]


def _x(shape, seed, dtype=np.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(dtype))


@pytest.mark.parametrize("shape", [(2, 3, 768), (2, 5, 4, 64), (1, 7, 37)])
def test_rms_norm_matches_jax(shape):
    import jax.numpy as jnp

    from repro.models import layers as jlayers

    x, scale = _x(shape, 0), _x(shape[-1:], 1) * 0.1
    got = rms_norm(x, scale).numpy()
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mean_square_on_the_cpu_is_the_plain_version():
    x = _x((4, 3, 48), 2)
    assert torch.equal(nkernel.mean_square(x), mean_square_ref(x))
    x.requires_grad_(True)
    assert nkernel.mean_square(x).grad_fn is not None


def test_kernel_route_backward_equals_the_plain_backward(monkeypatch):
    """``_MeanSquare`` with the plain forward in place of the launch: its
    backward gives the bits autograd gives the plain version."""
    monkeypatch.setattr(nkernel, "_mean_square_cuda", mean_square_ref)
    x, g = _x((3, 5, 40), 3), _x((3, 5, 1), 4)
    a = x.clone().requires_grad_(True)
    nkernel._MeanSquare.apply(a).backward(g)
    b = x.clone().requires_grad_(True)
    mean_square_ref(b).backward(g)
    assert torch.equal(a.grad, b.grad)


def test_plain_rows_do_not_depend_on_the_batch():
    x = _x((9, 300), 5)
    whole = mean_square_ref(x)
    for i in range(x.shape[0]):
        assert torch.equal(mean_square_ref(x[i:i + 1].clone()), whole[i:i + 1])


def test_kernel_constants_match_the_source():
    text = nkernel.LIBRARY.source.read_text()
    assert f"constexpr int kWarps = {nkernel.ROWS_PER_BLOCK};" in text


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_within_one_ulp(cuda, shape):
    x = _x(shape, 6).to(cuda)
    before = nkernel.ROW_MS.launches
    got = nkernel.mean_square(x)
    assert nkernel.ROW_MS.launches == before + 1
    want = mean_square_ref(x.cpu()).numpy()
    assert got.shape == (*shape[:-1], 1) and got.dtype == torch.float32
    assert (np.abs(got.cpu().numpy() - want) <= np.spacing(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 37, 8192])
def test_kernel_rows_do_not_depend_on_the_batch(cuda, d):
    x = _x((64, d), 7).to(cuda)
    whole = nkernel.mean_square(x)
    for rows in (1, 2, 3, 4, 8, 16, 33):
        part = nkernel.mean_square(x[:rows].clone())
        assert torch.equal(part, whole[:rows])


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_view_and_autograd(cuda):
    base = _x((4 * 64 + 1,), 8).to(cuda)
    view = base[1:].view(4, 64)           # 4 bytes past a 16-byte boundary
    assert torch.equal(nkernel.mean_square(view), nkernel.mean_square(view.clone()))
    x = _x((3, 96), 9).to(cuda).requires_grad_(True)
    g = _x((3, 1), 10).to(cuda)
    nkernel.mean_square(x).backward(g)
    plain = x.detach().cpu().requires_grad_(True)
    mean_square_ref(plain).backward(g.cpu())
    assert torch.equal(x.grad.cpu(), plain.grad)


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError):
        nkernel.mean_square(_x((2, 64), 11).to(cuda, torch.bfloat16))
