"""Wrapper of the hand-written SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` replaces the JAX package's Pallas kernel
``kernels/ssd_scan/kernel.py::_ssd_kernel``, and also returns what
``ssd_chunked(return_state=True)`` hands to decode (the final state) and,
in split mode, the state before each chunk.

A tensor's device decides the route: CPU tensors go to the plain version
(``ref.ssd_ref``); CUDA tensors go to the kernel, which raises on what it
does not take.  The wrapper makes x, b and c contiguous (on the model's path
they already are: reshapes of the contiguous conv outputs) and b and c
16-byte aligned (copying a view that is not), allocates the
float32 outputs, launches on PyTorch's current stream and counts the launch
on ``SSD``.  The kernel runs one block per (chunk, batch, head, slice of P)
(``ssd_launch_plan``) and joins the state across chunks inside the launch,
through per-stream counters that it leaves zero: one call is one launch.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from ..amr_matmul.kernel import _sm_count, _zeros, fills_the_card
from ..build import CudaKernel, CudaLibrary
from .ref import ssd_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "ssd_scan.cu")
LIBRARIES = (LIBRARY,)

_P, _I = ctypes.c_void_p, ctypes.c_int
SSD = CudaKernel("ssd_scan", LIBRARY, "ssd_scan",
                 [_P] * 5 + [_I] + [_P] * 4 + [_I] * 9 + [_P])
KERNELS = (SSD,)

THREADS = 256                # kThreads in ssd_scan.cu
TILE = 64                    # kTile: rows of a staged B or C tile
MAX_N = 128                  # kMaxN: the d_state the kernel takes
MAX_STATE_TILE = 8192        # kMaxStateTile: N x p_block at most
P_BLOCKS = (64, 32, 16)      # columns of P a block, widest first


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int, *, split: bool = False) -> tuple:
    """x (B, S, H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N) grouped.

    Returns ``(y, h_final)``, or with ``split=True`` ``(y_intra, h_prev,
    h_final)``, as ``ref.ssd_ref`` does; all float32.  S need not be a
    multiple of ``chunk``.
    """
    _check_shapes(x, dt, a_log, b, c)
    devices = {t.device for t in (x, dt, a_log, b, c)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = x.device
    if dev.type == "cpu":
        return ssd_ref(x, dt, a_log, b, c, chunk, split=split)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share float32 or bfloat16, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"dt and a_log must be float32, got {dt.dtype}, {a_log.dtype}")
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
    h_prev = torch.empty((B, plan.chunks, H, N, P) if split else (1,), dtype=torch.float32,
                         device=dev)
    counters = _zeros(dev, stream, 1 + B * H * plan.p_split, "ssd")
    SSD(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        int(x.dtype == torch.bfloat16), y.data_ptr(), h_prev.data_ptr(), h_final.data_ptr(),
        counters, B, S, H, P, G, N, chunk, plan.p_block, int(split), stream)
    return (y, h_prev, h_final) if split else (y, h_final)
