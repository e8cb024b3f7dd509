"""Approximate matmul modes: the AMR-MUL as a numerics policy.

The port of the JAX package's ``numerics/approx_matmul.py`` for the modes
this port serves:

  exact       — ``torch.matmul`` in the requested dtype (baseline).
  amr_lut     — bit-exact AMR-MUL semantics per scalar product: int8
                quantize, per-element gather from the 256x256 table,
                integer accumulation.  The plain oracle (small shapes).
  amr_kernel  — the hand-written CUDA kernels (kernels/amr_matmul): the
                low-rank kernel at ``rank``, or the bit-exact full-table
                gather kernel when ``rank == 0``.
  amr_inject  — exact AMR products of any schedule, DSE candidates
                included (``schedule_ref``), by replaying the reduction
                circuit: the hand-written kernel of kernels/inject_replay.

All functions take A: (..., M, K) and B: (K, N) or a batched B: (..., K, N)
whose leading dims broadcast against A's.  Quantization is per row of A
and per column of B, so a batched call equals stacking the per-group calls.

Dispatch goes through the mode table ``_MODES``; callers never compare mode
names.  The other modes of the JAX package (``amr_lowrank``,
``amr_noise``) are not ported yet and are refused when a policy names them.

Float products whose rows belong to different requests (the exact matmul
on a 2-D weight, split along A's leading request dim, and the float32
low-rank product of the grouped attention sites, split by group) run one
request or one group per ``torch.matmul``, so a request's result does not
depend on how many requests share the step: batched and solo decode give
the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.kernels.amr_matmul.ref import lut_matmul_ref

from .quant import quantize_int8, quantize_int8_ste


@dataclasses.dataclass(frozen=True)
class _Mode:
    impl: Callable[..., torch.Tensor]
    exact: bool = False
    needs_rank: bool = False


_NOT_YET_PORTED = ("amr_lowrank", "amr_noise")


@dataclasses.dataclass(frozen=True)
class AMRNumerics:
    """Numerics policy threaded through the model; validated at construction."""

    mode: str = "exact"
    border: int = 8  # approximate border column (paper Table I/II)
    rank: int = 8    # low-rank error rank; 0 in amr_kernel selects the full-LUT kernel
    # amr_inject: handle of a registered custom schedule (DSE candidate) from
    # numerics.injection.register_schedule; None = the paper's schedule for
    # (n_digits=2, border).
    schedule_ref: str | None = None

    def __post_init__(self):
        if self.mode in _NOT_YET_PORTED:
            raise NotImplementedError(
                f"numerics mode {self.mode!r} is not yet ported to repro_torch; "
                f"ported modes: {tuple(_MODES)}")
        spec = _MODES.get(self.mode)
        if spec is None:
            raise ValueError(f"unknown numerics mode {self.mode!r}; valid modes: {tuple(_MODES)}")
        if spec.exact:
            return
        if not isinstance(self.border, int) or self.border < 0:
            raise ValueError(f"numerics mode {self.mode!r} needs a non-negative integer "
                             f"border, got {self.border!r}")
        if spec.needs_rank and (not isinstance(self.rank, int) or self.rank < 0):
            raise ValueError(f"numerics mode {self.mode!r} needs an integer rank >= 0, "
                             f"got {self.rank!r}")
        if self.schedule_ref is not None and not isinstance(self.schedule_ref, str):
            raise ValueError(f"schedule_ref must be a registered-schedule handle (str) or "
                             f"None, got {self.schedule_ref!r}")

    def is_exact(self) -> bool:
        return _MODES[self.mode].exact


def _per_request(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (K, N) as one (M, K) @ (K, N) ``torch.matmul`` per
    slice of A's leading dims (a request's tokens).

    Each slice is copied to a fresh tensor, so BLAS sees the same call
    (shape and alignment) whatever batch the request came in; a product over
    the whole batch may sum a row in another order when the batch is larger.
    A prefill (one request) stays one call; a decode step is one call per
    request.
    """
    a3 = a.reshape(-1, *a.shape[-2:])
    outs = [torch.matmul(a3[i].clone(), b) for i in range(a3.shape[0])]
    out = torch.stack(outs) if outs else a3.new_empty((0, a.shape[-2], b.shape[-1]))
    return out.reshape(*a.shape[:-1], b.shape[-1])


def matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in the operands' dtype; one call per request on a
    2-D B when A has a leading (request) dim."""
    return _per_request(a, b) if b.dim() == 2 and a.dim() > 2 else torch.matmul(a, b)


def matmul_amr_lut(a: torch.Tensor, b: torch.Tensor, border: int) -> torch.Tensor:
    """Bit-exact AMR-MUL matmul via the plain gather (oracle; small shapes).

    Raises ``ValueError`` when K * max|product| could saturate int32, as the
    JAX package's oracle does.
    """
    from repro_torch.kernels.amr_matmul.ops import check_accumulation  # lazy: import cycle

    check_accumulation(a.shape[-1], border, f"amr_lut(border={border})")
    qa, sa = quantize_int8(a, axis=-1)
    qb, sb = quantize_int8(b, axis=-2)
    acc = lut_matmul_ref(qa, qb, lut_lib.table_tensor(border, a.device)).float()
    return acc * sa * sb


def _lowrank_fwd(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    """Grouped (G, M, K) @ (G, K, N) augmented-K product with bf16 error
    lanes and float32 accumulation.

    Per k the contraction lanes are [exact, err_1..err_r] on both sides; the
    bf16 lane values are exact in float32, so the float32 matmul accumulates
    them as the JAX package's ``preferred_element_type=float32`` product
    does (in another order).
    """
    u, v = lut_lib.factor_tensors(border, rank, a.device)
    qa, sa = quantize_int8_ste(a, axis=-1)
    qb, sb = quantize_int8_ste(b, axis=-2)
    ia = qa.to(torch.int64) + 128
    ib = qb.to(torch.int64) + 128
    K = a.shape[-1]
    ua = u[ia].to(torch.bfloat16)                        # (..., M, K, r)
    vb = v[ib].to(torch.bfloat16)                        # (..., K, N, r)
    a_aug = torch.cat([qa[..., None].to(torch.bfloat16), ua], dim=-1)
    a_aug = a_aug.reshape(*a.shape[:-1], K * (1 + rank))
    b_aug = torch.cat([qb[..., :, None, :].to(torch.bfloat16), vb.movedim(-1, -2)], dim=-2)
    b_aug = b_aug.reshape(*b.shape[:-2], K * (1 + rank), b.shape[-1])
    # one product per group: a group is one request's (kv head's) rows
    out = torch.stack([torch.matmul(a_aug[g].float(), b_aug[g].float())
                       for g in range(a.shape[0])])
    return out * sa * sb


def _broadcast_groups(a: torch.Tensor, b: torch.Tensor):
    """Broadcast A/B leading dims together and flatten them to one group
    axis: (..., M, K), (..., K, N) -> (G, M, K), (G, K, N), lead-shape."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:])
    g = math.prod(lead) if lead else 1
    return a3.reshape(g, *a.shape[-2:]), b3.reshape(g, *b.shape[-2:]), lead


def matmul_amr_kernel(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    """Kernel-backed AMR matmul (the serving hot path), forward only.

    A 2-D weight takes ``amr_matmul``: the full-LUT kernel at rank 0, the
    low-rank kernel otherwise.  A batched B (activation x activation) takes
    the grouped full-LUT kernel at rank 0 and the augmented-K matmul of
    ``_lowrank_fwd`` at rank > 0, the split the JAX package makes.
    """
    from repro_torch.kernels.amr_matmul.ops import (amr_matmul,  # lazy: import cycle
                                                    amr_matmul_grouped)

    if b.dim() == 2:
        a2 = a.reshape(-1, a.shape[-1])
        out = amr_matmul(a2, b, border=border, rank=max(rank, 1),
                         method="lut" if rank == 0 else "lowrank")
        return out.reshape(*a.shape[:-1], b.shape[-1])
    a3, b3, lead = _broadcast_groups(a, b)
    if rank == 0:
        out = amr_matmul_grouped(a3, b3, border=border)
    else:
        out = _lowrank_fwd(a3, b3, border, rank)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def matmul_amr_inject(a: torch.Tensor, b: torch.Tensor, numerics: AMRNumerics) -> torch.Tensor:
    """Exact per-product AMR error for any schedule, forward only.

    Quantizes both operands as the straight-through form does, replays the
    schedule's reduction circuit for every operand pair (the
    ``inject_replay`` kernel for CUDA tensors, its plain version for CPU
    tensors) and rescales, ``acc.float() * sa * sb``.  A 2-D B takes the
    replay matmul, a batched B (activation x activation) its grouped form.
    Bit-identical to ``matmul_amr_lut`` on the same schedule's table for
    inputs whose two quantizers agree (float32).
    """
    from repro_torch.kernels.inject_replay.ops import (  # lazy: import cycle
        inject_replay_matmul, inject_replay_matmul_grouped)

    from . import injection

    inj = injection.get_injector(numerics)
    qa, sa = quantize_int8_ste(a, axis=-1)
    qb, sb = quantize_int8_ste(b, axis=-2)
    ia = qa.to(torch.int32) + 128                       # (..., M, K)
    ib = qb.to(torch.int32) + 128                       # (..., K, N)
    handle = numerics.schedule_ref
    if ib.dim() > 2:
        ia3, ib3, lead = _broadcast_groups(ia, ib)
        acc = inject_replay_matmul_grouped(inj, ia3, ib3, schedule=handle)
        acc = acc.reshape(*lead, ia.shape[-2], ib.shape[-1])
    else:
        acc = inject_replay_matmul(inj, ia, ib, schedule=handle)
    return acc.float() * sa * sb


_MODES: dict[str, _Mode] = {
    "exact": _Mode(lambda a, b, nm: matmul_exact(a, b), exact=True),
    "amr_lut": _Mode(lambda a, b, nm: matmul_amr_lut(a, b, nm.border)),
    "amr_kernel": _Mode(lambda a, b, nm: matmul_amr_kernel(a, b, nm.border, nm.rank),
                        needs_rank=True),
    "amr_inject": _Mode(matmul_amr_inject),
}


def mode_names() -> tuple[str, ...]:
    """The modes this port serves, in canonical order."""
    return tuple(_MODES)


def approx_matmul(a: torch.Tensor, b: torch.Tensor, numerics: AMRNumerics | None = None,
                  *, site: str | None = None) -> torch.Tensor:
    """Dispatch a matmul under the given numerics policy (None = exact).

    ``site`` is the call-site label (e.g. ``"attn.qk"``), kept on every call
    so that per-site policies and audits can address the sites when they are
    ported; no mode of this port reads it yet.
    """
    if numerics is None or numerics.is_exact():
        return matmul_exact(a, b)
    return _MODES[numerics.mode].impl(a, b, numerics)
