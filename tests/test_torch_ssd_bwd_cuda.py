"""The SSD scan's backward kernel against the plain backward, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present.  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_bwd_cuda.py

The plain backward is torch autograd through ``ssd_scan.ref.ssd_ref``
(``ref.ssd_ref_grads``).  Tolerance (``ref.ssd_grad_excess`` at
``ref.ssd_grad_rtol``): each gradient within 1e-4 of its largest |value|
(float32 sums in other orders) plus the relative error of a decay factor
when the two sides round the cumulative log decay in other orders
(2**-23 * 16 * (1 + max |cum|): 6e-3 with the model's dt, 2e-6 with the
scaled dt below), plus one bf16 rounding step where the gradient is bf16.
With the model's dt a chunk decays the state to 0, which hides the reverse
join across chunks; inputs with dt scaled per head (a chunk decays the
state by exp(-0.5)) make the join's share of each gradient
(``ssd_carried_grads``) exceed that tolerance a hundredfold, and a copy of
the source that drops the join must fail there; a copy whose merged pass
leaves out the dB of the pairs past the diagonal tiles must fail with the
model's dt.
"""
import ctypes
import math

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import CudaKernel, CudaLibrary, build_all
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ref as sref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, H, P, N, G, dtype, device, chunk, carry, split, seed=0):
    """(x, dt, a_log, b, c) as ``test_torch_kernels_cuda._ssd_inputs`` makes
    them, and seeded gradients of the outputs."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    if carry:
        dt = torch.rand((B, S, H), generator=g, device=device) / (torch.exp(a_log) * chunk)
    else:
        dt = torch.nn.functional.softplus(normal(B, S, H))
    args = (normal(B, S, H, P).to(dtype), dt, a_log, normal(B, S, G, N).to(dtype),
            normal(B, S, G, N).to(dtype))
    nc = math.ceil(S / chunk)
    grads = (normal(B, S, H, P), normal(B, nc, H, N, P) if split else None, normal(B, H, N, P))
    return args, grads


def _kernel_grads(args, grads, chunk, split):
    _, h_prev, _ = skernel._scan_cuda(*args, chunk, split, keep_states=True)
    return skernel.ssd_scan_bwd(*args, h_prev, *grads, chunk)


def _plain_grads(args, grads, chunk, split):
    dy, dh_prev, dh_final = grads
    return sref.ssd_ref_grads(*args, chunk, (dy, dh_prev, dh_final) if split else (dy, dh_final),
                              split=split)


# (B, S, H, P, N, G, chunk, dtype): mamba2-370m's widths at a 16-token
# prompt and at its training context, zamba2-1.2b's at 1024 tokens, a ragged
# last chunk with G < H, the reduced configs' widths
SHAPES = [(1, 16, 32, 64, 128, 1, 256, torch.bfloat16),
          (2, 2048, 32, 64, 128, 1, 256, torch.bfloat16),
          (1, 1024, 64, 64, 64, 1, 256, torch.bfloat16),
          (2, 300, 8, 32, 64, 2, 128, torch.float32),
          (1, 37, 4, 16, 16, 1, 16, torch.float32)]


@pytest.mark.parametrize("carry", [False, True], ids=["model-dt", "carry"])
@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype", SHAPES)
def test_ssd_bwd_within_tolerance_of_plain(cuda, B, S, H, P, N, G, chunk, dtype, split, carry):
    args, grads = _inputs(B, S, H, P, N, G, dtype, cuda, chunk, carry, split)
    got = _kernel_grads(args, grads, chunk, split)
    want = _plain_grads(args, grads, chunk, split)
    rtol = sref.ssd_grad_rtol(args[1], args[2], chunk)
    torch.cuda.synchronize()
    for name, g, w, a in zip(("dx", "ddt", "da_log", "db", "dc"), got, want, args):
        assert g.shape == w.shape and g.dtype == a.dtype and bool(torch.isfinite(g).all()), name
        assert sref.ssd_grad_excess(g, w, rtol) <= 1.0, (name, sref.ssd_grad_excess(g, w, rtol))


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_ssd_bwd_join_is_visible_with_scaled_dt(cuda, split):
    """On the carry inputs the reverse join's share of dx, ddt, da_log and
    db exceeds the tolerance a hundredfold, so the check above sees it."""
    args, grads = _inputs(1, 1024, 32, 64, 128, 1, torch.bfloat16, cuda, 256, True, split)
    dy, dh_prev, dh_final = grads
    carried = sref.ssd_carried_grads(*args, 256, (dy, dh_prev, dh_final) if split else
                                     (dy, dh_final), split=split)
    want = _plain_grads(args, grads, 256, split)
    rtol = sref.ssd_grad_rtol(args[1], args[2], 256)
    for name, cr, w in zip(("dx", "ddt", "da_log", "db"), carried, want):
        ratio = float(cr.abs().max()) / (rtol * float(w.float().abs().max()))
        assert ratio >= 100.0, (name, ratio)


# name: (a line of the source, its planted replacement, the inputs that must
# show it): the reverse join dropped or halved (only the carry inputs carry a
# state across chunks); the merged pass's dB without the pairs whose t tile
# lies past the s tile (their rows meet at t - s = 1, so the model's dt
# shows it)
_DB_OFF_DIAGONAL = ("if (4 * (lq + 16 * r) < N) "
                    "outer(bacc[r], a_dm, ld4(s_c + k * ldn + 4 * (lq + 16 * r)));")
PLANTS = {
    "drop_join": ("gv[j] = racc[r][i][j] + decay_q * dv[j] + pv[j];",
                  "gv[j] = racc[r][i][j] + pv[j];", True),
    "half_join": ("gv[j] = racc[r][i][j] + decay_q * dv[j] + pv[j];",
                  "gv[j] = racc[r][i][j] + 0.5f * decay_q * dv[j] + pv[j];", True),
    "drop_db_off_diagonal": (_DB_OFF_DIAGONAL, _DB_OFF_DIAGONAL.replace(
        "if (4 * (lq + 16 * r) < N)", "if (4 * (lq + 16 * r) < N && t0 < s0 + kS)"), False),
}


@pytest.fixture(scope="module")
def bwd_plants(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = skernel.LIBRARY_BWD.source.read_text()
    root = tmp_path_factory.mktemp("ssd_bwd_plants")
    libs = {}
    for name, (old, new, _) in PLANTS.items():
        assert src.count(old) == 1, name
        path = root / f"ssd_scan_bwd_{name}.cu"
        path.write_text(src.replace(old, new))
        libs[name] = CudaLibrary(path)
    with pytest.MonkeyPatch.context() as mp:  # the planted libraries stay out of the checkout
        mp.setattr(build, "BUILD_DIR", root)
        build_all(list(libs.values()))
        for lib in libs.values():
            lib.handle()
    return libs


@pytest.mark.parametrize("plant", list(PLANTS))
def test_ssd_bwd_check_fails_a_planted_fault(cuda, bwd_plants, monkeypatch, capsys, plant):
    monkeypatch.setattr(skernel, "SSD_BWD", CudaKernel("ssd_scan_bwd", bwd_plants[plant],
                                                       "ssd_scan_bwd", skernel.SSD_BWD.argtypes))
    carry = PLANTS[plant][2]
    worst = []
    for split in (False, True):
        args, grads = _inputs(1, 1024, 32, 64, 128, 1, torch.bfloat16, cuda, 256, carry, split)
        got = _kernel_grads(args, grads, 256, split)
        want = _plain_grads(args, grads, 256, split)
        rtol = sref.ssd_grad_rtol(args[1], args[2], 256)
        worst.append(max(sref.ssd_grad_excess(g, w, rtol) for g, w in zip(got, want)))
    with capsys.disabled():
        print(f"\n[plant] {plant}: excess full {worst[0]:.4g} split {worst[1]:.4g}")
    assert min(worst) > 1.0, worst


def test_ssd_bwd_repeats_bit_for_bit(cuda):
    """No float atomics: the same call gives the same bits, with calls of
    other shapes between (the counters are left zero); the wrapper's shared
    memory matches the source's."""
    first, fg = _inputs(2, 2048, 32, 64, 128, 1, torch.bfloat16, cuda, 256, True, True)
    other, og = _inputs(2, 300, 8, 32, 64, 2, torch.float32, cuda, 128, True, False)
    want = _kernel_grads(first, fg, 256, True)
    for _ in range(3):
        _kernel_grads(other, og, 128, False)
        got = _kernel_grads(first, fg, 256, True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    fn = skernel.LIBRARY_BWD.handle().ssd_scan_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for n, p, q in ((128, 64, 256), (16, 16, 16), (64, 64, 256), (64, 32, 128)):
        assert fn(n, p, q) == skernel.ssd_bwd_smem_bytes(n, p, q)


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_autograd_through_ssd_scan_runs_the_backward_kernel(cuda, split):
    """Under autograd a CUDA call is one forward launch and, in the
    backward, one backward launch, with the plain backward's gradients."""
    args, grads = _inputs(1, 600, 8, 64, 64, 1, torch.bfloat16, cuda, 256, True, split)
    ins = [t.clone().requires_grad_(True) for t in args]
    skernel.SSD.launches = skernel.SSD_BWD.launches = 0
    outs = skernel.ssd_scan(*ins, 256, split=split)
    used = [g for g in grads if g is not None]
    got = torch.autograd.grad(outs, ins, used)
    torch.cuda.synchronize()
    assert (skernel.SSD.launches, skernel.SSD_BWD.launches) == (1, 1)
    want = _plain_grads(args, grads, 256, split)
    rtol = sref.ssd_grad_rtol(args[1], args[2], 256)
    for g, w in zip(got, want):
        assert sref.ssd_grad_excess(g, w, rtol) <= 1.0
    with torch.no_grad():  # no autograd: the forward alone, keeping no states
        y = skernel.ssd_scan(*ins, 256, split=split)[0]
    assert y.grad_fn is None and skernel.SSD.launches == 2


def test_ssd_bwd_rejects_what_the_kernel_does_not_take(cuda):
    args, grads = _inputs(1, 64, 2, 128, 16, 1, torch.float32, cuda, 16, False, False)
    h_prev = torch.zeros((1, 4, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError, match="P <= 64"):
        skernel.ssd_scan_bwd(*args, h_prev, *grads, 16)
    args, grads = _inputs(1, 64, 2, 16, 16, 1, torch.float32, cuda, 16, False, False)
    with pytest.raises(ValueError, match="do not fit"):
        skernel.ssd_scan_bwd(*args, h_prev, *grads, 16)
    with pytest.raises(TypeError, match="float32"):
        skernel.ssd_scan_bwd(*args, torch.zeros((1, 4, 2, 16, 16), device=cuda),
                             grads[0].double(), None, grads[2], 16)
