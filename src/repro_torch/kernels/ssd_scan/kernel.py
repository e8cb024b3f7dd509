"""Wrappers of the hand-written SSD chunked-scan kernels (``csrc/ssd_scan.cu``
and its backward, ``csrc/ssd_scan_bwd.cu``).

``ssd_scan`` replaces the JAX package's Pallas kernel
``kernels/ssd_scan/kernel.py::_ssd_kernel``, and also returns what
``ssd_chunked(return_state=True)`` hands to decode (the final state) and,
in split mode, the state before each chunk.  Where autograd records (grad
enabled and an input that requires it), a CUDA call runs inside
``_SsdScan``, a ``torch.autograd.Function`` whose backward is the
hand-written backward kernel (``ssd_scan_bwd``, which the JAX package has
no Pallas counterpart of: it differentiates its jnp scan); the forward
then keeps the state before each chunk in full mode too (``keep_states``:
(B, nc, H, N, P) float32, 33.5 MB a layer for mamba2-370m at 4 x 2048
tokens), which the backward reads instead of recomputing the scan.

A tensor's device decides the route: CPU tensors go to the plain version
(``ref.ssd_ref``, which autograd differentiates: the plain backward);
CUDA tensors go to the kernels, which raise on what they do not take.  The
wrapper makes x, b and c contiguous (on the model's path they already are:
reshapes of the contiguous conv outputs) and b and c 16-byte aligned
(copying a view that is not), allocates the float32 outputs, launches on
PyTorch's current stream and counts the launch on ``SSD`` (the backward
on ``SSD_BWD``).  The kernel runs one block per (chunk, batch, head, slice
of P) (``ssd_launch_plan``) and joins the state across chunks inside the
launch, through per-stream counters that it leaves zero: one call is one
launch.  The backward runs one block per (chunk, batch, head), two an SM,
last chunk first, and joins the state gradient across chunks the same way;
it computes each masked tile of the lower triangle once, per 64-row s tile
and 32-row t tile (``BWD_S_TILE``, ``BWD_T_TILE``).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..amr_matmul.kernel import _sm_count, _zeros, fills_the_card
from ..build import CudaKernel, CudaLibrary
from .ref import ssd_ref, ssd_ref_grads

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "ssd_scan.cu")
LIBRARY_BWD = CudaLibrary(_CSRC / "ssd_scan_bwd.cu")
LIBRARIES = (LIBRARY, LIBRARY_BWD)

_P, _I = ctypes.c_void_p, ctypes.c_int
SSD = CudaKernel("ssd_scan", LIBRARY, "ssd_scan",
                 [_P] * 5 + [_I] + [_P] * 4 + [_I] * 10 + [_P])
SSD_BWD = CudaKernel("ssd_scan_bwd", LIBRARY_BWD, "ssd_scan_bwd",
                     [_P] * 5 + [_I] + [_P] * 11 + [_I] * 8 + [_P])
KERNELS = (SSD, SSD_BWD)

THREADS = 256                # kThreads in ssd_scan.cu
TILE = 64                    # kTile: rows of a staged B or C tile
MAX_N = 128                  # kMaxN: the d_state the kernel takes
MAX_STATE_TILE = 8192        # kMaxStateTile: N x p_block at most
P_BLOCKS = (64, 32, 16)      # columns of P a block, widest first
BWD_THREADS = 256            # kThreads in ssd_scan_bwd.cu
BWD_S_TILE = 64              # kS: rows of an s tile (B_s, u_s; dB_s and du_s in registers)
BWD_T_TILE = 32              # kT: rows of a t tile (C_t, dy_t)
BWD_MAX_P = 64               # kMaxP: the head_dim the backward takes
BWD_LD_M = BWD_S_TILE + 4    # kLdM: leading dimension of the M and dM o dec tiles
BWD_PARTS = 256              # kParts: per-warp partials of the row sums into dcum


class SsdPlan(NamedTuple):
    """An SSD launch: columns of P a block, the P slices, the chunks, the
    blocks (one per chunk, batch, head and P slice; the kernel hands them
    out chunk-major, then batch, head and slice) and the dynamic shared
    memory of a block in bytes."""
    p_block: int
    p_split: int
    chunks: int
    blocks: int
    smem: int


def ssd_smem_bytes(N: int, chunk: int, p_block: int) -> int:
    """A block's dynamic shared memory (``smem_floats`` in ssd_scan.cu): the
    C and B tiles, the masked C B^T tile, x dt of a chunk, the state and
    three per-row arrays."""
    rows = math.ceil(chunk / TILE) * TILE
    return 4 * (2 * TILE * (N + 4) + TILE * (TILE + 4) + rows * p_block + N * p_block + 3 * rows)


def ssd_bwd_smem_bytes(N: int, P: int, chunk: int) -> int:
    """A backward block's dynamic shared memory (``smem_floats`` in
    ssd_scan_bwd.cu): the s region (B_s and x dt rows of an s tile, or h_c^T
    in the readout pass), the t region (C_t and dy_t rows of a t tile, M and
    dM o dec, or D or D^T for the state terms), five per-row arrays and the
    partials."""
    ldn, ldp = N + 4, P + 4
    region_s = max(BWD_S_TILE * (ldn + ldp), P * ldn)
    region_t = max(BWD_T_TILE * (ldn + ldp + 2 * BWD_LD_M), N * ldp, P * ldn)
    rows = math.ceil(chunk / BWD_S_TILE) * BWD_S_TILE
    return 4 * (region_s + region_t + 5 * rows + BWD_PARTS)


@lru_cache(maxsize=256)
def ssd_launch_plan(B: int, S: int, H: int, P: int, N: int, chunk: int, sms: int) -> SsdPlan:
    """The widest P slice (64, 32 or 16 columns, dividing P, with N x
    p_block <= 8192) unless the blocks would not fill the card
    (``fills_the_card``): then narrower slices, down to 16 columns, so that
    a short prompt (one chunk a head) still spreads over the SMs.  A wider
    slice computes C B^T once for more columns."""
    chunks = math.ceil(S / chunk)
    fits = [pb for pb in P_BLOCKS if P % pb == 0 and N * pb <= MAX_STATE_TILE]
    if not fits:
        raise ValueError(f"the SSD kernel takes head_dim P % 16 == 0 and d_state N <= "
                         f"{MAX_N}, got P={P}, N={N}")
    p_block = fits[0]
    for pb in fits:
        p_block = pb
        if fills_the_card(chunks * B * H * (P // pb), sms):
            break
    p_split = P // p_block
    return SsdPlan(p_block, p_split, chunks, chunks * B * H * p_split,
                   ssd_smem_bytes(N, chunk, p_block))


@lru_cache(maxsize=8)
def _max_smem(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _check_shapes(x, dt, a_log, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B, S, H, P), dt (B, S, H), a_log (H,), b/c "
                         f"(B, S, G, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    B, S, H, _ = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(a_log.shape) != (H,) or b.shape != c.shape \
            or tuple(b.shape[:2]) != (B, S) or H % b.shape[2]:
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a_log {tuple(a_log.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")


def _check_cuda(x, dt, a_log, b, c) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share float32 or bfloat16, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"dt and a_log must be float32, got {dt.dtype}, {a_log.dtype}")


def _device(*ts) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got {dev}")
    return dev


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int, *, split: bool = False) -> tuple:
    """x (B, S, H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N) grouped.

    Returns ``(y, h_final)``, or with ``split=True`` ``(y_intra, h_prev,
    h_final)``, as ``ref.ssd_ref`` does; all float32.  S need not be a
    multiple of ``chunk``.  Differentiable on both routes: gradients of
    every output reach x, dt, a_log, b and c.
    """
    _check_shapes(x, dt, a_log, b, c)
    if _device(x, dt, a_log, b, c).type == "cpu":
        return ssd_ref(x, dt, a_log, b, c, chunk, split=split)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a_log, b, c)):
        return _SsdScan.apply(x, dt, a_log, b, c, chunk, split)
    y, h_prev, h_final = _scan_cuda(x, dt, a_log, b, c, chunk, split, keep_states=False)
    return (y, h_prev, h_final) if split else (y, h_final)


def _scan_cuda(x, dt, a_log, b, c, chunk: int, split: bool, keep_states: bool) -> tuple:
    """One launch of the forward kernel -> (y, h_prev, h_final); h_prev is a
    placeholder unless ``split`` or ``keep_states``."""
    _check_cuda(x, dt, a_log, b, c)
    dev = x.device
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if P % 16:
        raise ValueError(f"the SSD kernel takes head_dim P % 16 == 0, got {P}")
    if N % 4 or N > MAX_N:
        raise ValueError(f"the SSD kernel takes d_state N % 4 == 0 and N <= {MAX_N}, got {N}")
    plan = ssd_launch_plan(B, S, H, P, N, chunk, _sm_count(dev))
    if plan.smem > _max_smem(dev):
        raise ValueError(f"the SSD kernel needs {plan.smem} bytes of shared memory for d_state "
                         f"{N} and chunk {chunk}; the card allows {_max_smem(dev)}")
    x, dt, a_log, b, c = (t.contiguous() for t in (x, dt, a_log, b, c))
    # the kernel reads b and c two elements a load: a view at an odd offset is copied
    b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (b, c))
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    h_prev = torch.empty((B, plan.chunks, H, N, P) if split or keep_states else (1,),
                         dtype=torch.float32, device=dev)
    counters = _zeros(dev, stream, 1 + B * H * plan.p_split, "ssd")
    SSD(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        int(x.dtype == torch.bfloat16), y.data_ptr(), h_prev.data_ptr(), h_final.data_ptr(),
        counters, B, S, H, P, G, N, chunk, plan.p_block, int(split), int(keep_states), stream)
    return y, h_prev, h_final


class _SsdScan(torch.autograd.Function):
    """The CUDA scan under autograd: the forward kernel keeping the state
    before each chunk, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk, split):
        y, h_prev, h_final = _scan_cuda(x, dt, a_log, b, c, chunk, split, keep_states=True)
        ctx.chunk, ctx.split = chunk, split
        ctx.save_for_backward(x, dt, a_log, b, c, h_prev)
        return (y, h_prev, h_final) if split else (y, h_final)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        x, dt, a_log, b, c, h_prev = ctx.saved_tensors
        dy, dh_prev, dh_final = grads if ctx.split else (grads[0], None, grads[1])
        return (*ssd_scan_bwd(x, dt, a_log, b, c, h_prev, dy, dh_prev, dh_final, ctx.chunk),
                None, None)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, h_prev: torch.Tensor, dy: torch.Tensor,
                 dh_prev: torch.Tensor | None, dh_final: torch.Tensor, chunk: int) -> tuple:
    """The gradients (dx, ddt, da_log, db, dc) of ``ssd_scan``'s outputs,
    given their gradients: dy (B, S, H, P), in split mode dh_prev (B, nc, H,
    N, P) (None in full mode), dh_final (B, H, N, P); ``h_prev`` is the
    forward's state before each chunk.  Each gradient in its input's dtype;
    db and dc summed over the heads of a group in float32 (the kernel's
    per-head sums, added in head order) before the cast.  da_log is the sum
    of the kernel's per-(chunk, batch) partials.  CPU tensors take the plain
    backward (``ref.ssd_ref_grads``, which recomputes the forward)."""
    _check_shapes(x, dt, a_log, b, c)
    split = dh_prev is not None
    dev = _device(x, dt, a_log, b, c, h_prev, dy, dh_final)
    if dev.type == "cpu":
        grads = (dy, dh_prev, dh_final) if split else (dy, dh_final)
        return ssd_ref_grads(x, dt, a_log, b, c, chunk, grads, split=split)
    _check_cuda(x, dt, a_log, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = math.ceil(S / chunk)
    if P % 4 or P > BWD_MAX_P or N % 4 or N > MAX_N:
        raise ValueError(f"the SSD backward kernel takes head_dim P % 4 == 0, P <= {BWD_MAX_P} "
                         f"and d_state N % 4 == 0, N <= {MAX_N}; got P={P}, N={N}")
    smem = ssd_bwd_smem_bytes(N, P, chunk)
    if smem > _max_smem(dev):
        raise ValueError(f"the SSD backward kernel needs {smem} bytes of shared memory for "
                         f"d_state {N}, head_dim {P} and chunk {chunk}; the card allows "
                         f"{_max_smem(dev)}")
    states = (B, nc, H, N, P)
    if tuple(h_prev.shape) != states or tuple(dy.shape) != (B, S, H, P) or \
            tuple(dh_final.shape) != (B, H, N, P) or (split and tuple(dh_prev.shape) != states):
        raise ValueError(f"ssd_scan_bwd: h_prev {tuple(h_prev.shape)}, dy {tuple(dy.shape)}, "
                         f"dh_final {tuple(dh_final.shape)} do not fit x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)} and chunk {chunk}")
    for name, t in (("h_prev", h_prev), ("dy", dy), ("dh_final", dh_final), ("dh_prev", dh_prev)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    x, dt, a_log, b, c, h_prev, dy, dh_final = (
        t.contiguous() for t in (x, dt, a_log, b, c, h_prev, dy, dh_final))
    # the kernel reads x, b, c and dy four elements a load: a view at an odd offset is copied
    x, b, c, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, b, c, dy))
    dh_prev = dh_prev.contiguous() if split else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((B, S, H), **f32)
    da_part = torch.empty((nc, B, H), **f32)
    dbh = torch.empty((B, S, H, N), **f32)
    dch = torch.empty((B, S, H, N), **f32)
    dstates = torch.empty(states, **f32)
    counters = _zeros(dev, stream, 1 + B * H, "ssd_bwd")
    SSD_BWD(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
            int(x.dtype == torch.bfloat16), dy.data_ptr(), dh_prev.data_ptr() if split else None,
            dh_final.data_ptr(), h_prev.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_part.data_ptr(), dbh.data_ptr(), dch.data_ptr(), dstates.data_ptr(), counters,
            B, S, H, P, G, N, chunk, int(split), stream)
    rep = H // G
    db, dc = (t.view(B, S, G, rep, N).sum(dim=3).to(b.dtype) for t in (dbh, dch))
    return dx, ddt, da_part.sum(dim=(0, 1)), db, dc
