"""Wrapper of the hand-written SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` replaces the JAX package's Pallas kernel
``kernels/ssd_scan/kernel.py::_ssd_kernel``, and also returns what
``ssd_chunked(return_state=True)`` hands to decode (the final state) and,
in split mode, the state before each chunk.

A tensor's device decides the route: CPU tensors go to the plain version
(``ref.ssd_ref``); CUDA tensors go to the kernel, which raises on what it
does not take.  The wrapper makes x, b and c contiguous (on the model's path
they already are: reshapes of the contiguous conv outputs), allocates the
float32 outputs, launches on PyTorch's current stream and counts the launch
on ``SSD``.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path

import torch

from ..build import CudaKernel, CudaLibrary
from .ref import ssd_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "ssd_scan.cu")
LIBRARIES = (LIBRARY,)

_P, _I = ctypes.c_void_p, ctypes.c_int
SSD = CudaKernel("ssd_scan", LIBRARY, "ssd_scan",
                 [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
KERNELS = (SSD,)

P_BLOCK = 16  # kPB in ssd_scan.cu: columns of P per block


@lru_cache(maxsize=8)
def _max_smem(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


@lru_cache(maxsize=16)
def _smem_bytes(n: int, chunk: int) -> int:
    fn = LIBRARY.handle().ssd_scan_smem_bytes
    fn.argtypes, fn.restype = [_I, _I], ctypes.c_longlong
    return int(fn(n, chunk))


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
    if P % P_BLOCK:
        raise ValueError(f"the SSD kernel takes head_dim P % {P_BLOCK} == 0, got {P}")
    smem = _smem_bytes(N, chunk)
    if smem > _max_smem(dev):
        raise ValueError(f"the SSD kernel needs {smem} bytes of shared memory for d_state {N} "
                         f"and chunk {chunk}; the card allows {_max_smem(dev)}")
    x, dt, a_log, b, c = (t.contiguous() for t in (x, dt, a_log, b, c))
    nc = math.ceil(S / chunk)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    h_prev = torch.empty((B, nc, H, N, P) if split else (1,), dtype=torch.float32, device=dev)
    SSD(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        int(x.dtype == torch.bfloat16), y.data_ptr(), h_prev.data_ptr(), h_final.data_ptr(),
        B, S, H, P, G, N, chunk, int(split),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    return (y, h_prev, h_final) if split else (y, h_final)
