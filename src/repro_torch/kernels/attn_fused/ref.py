"""Plain PyTorch versions of the fused AMR attention kernels.

Both take the integer operands and the scales the op makes, so a kernel and
its plain version see the same inputs: q (G, M, D), kt (G, D, T), v (G, T, P)
int8; sq (G, M, 1), sk (G, 1, T), sv (G, 1, P) float32; mask (G, M, T) (0 =
masked).  They compute the kernels' chain with its order written out:

    acc = QK^T (table gather or circuit replay), int32
    s   = acc.float() * sq * sk / scale;  NEG_INF where masked
    e   = exp(s - rowmax(s));  sum = lane_order_sum(e);  p = e / sum
    ps  = clamp(max|p|, 1e-8) / 127;  q_p = clamp(round(p / ps), -128, 127)
    out = PV(q_p, v).float() * ps * sv

Every division divides by a tensor: on the card, PyTorch turns a division
by a Python number into a multiplication by its reciprocal, which rounds
differently.  The row sum's order is part of the function
(``lane_order_sum``); the kernels (``csrc/attn_softmax.cuh``) add in the
same order, and take max|p| as fl(1 / sum), which it equals.  The kernel
wrappers (``kernel.py``) run these for CPU tensors; ``chip_smoke.py`` and
the CUDA tests hold the kernels to them bit for bit on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import CompiledInjector
from repro_torch.kernels.amr_matmul.ref import lut_matmul_ref
from repro_torch.kernels.inject_replay.ref import MAX_PAIRS_PER_CHUNK, replay_matmul_ref

NEG_INF = -2.0e38  # the models' mask fill, bit for bit
LANES = 32


def lane_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x (..., T) -> (..., 1) in the kernels' fixed order.

    T is padded with zeros to a multiple of 32; lane j adds columns j,
    j + 32, j + 64, ... in increasing order; then the 32 lane sums halve,
    x[..., :16] + x[..., 16:] and so on down to one (the bits of a warp's
    xor-16/8/4/2/1 butterfly, float addition being commutative).  Adding a
    pad zero changes no sum, so the order depends on T alone.
    """
    pad = (-x.shape[-1]) % LANES
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    cols = x.reshape(*x.shape[:-1], -1, LANES)
    acc = torch.zeros_like(cols[..., 0, :])
    for i in range(cols.shape[-2]):
        acc = acc + cols[..., i, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc


def softmax_requant(acc: torch.Tensor, sq: torch.Tensor, sk: torch.Tensor, mask: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 scores (G, M, T) -> the re-quantized probabilities: q_p int8
    (G, M, T) and their per-row scale ps float32 (G, M, 1).

    The twin of the JAX package's ``_quantize_probs`` (absmax over the row,
    eps 1e-8, / 127, round half to even, clip) on a softmax whose row sum
    runs in ``lane_order_sum``'s order.
    """
    s = acc.float() * sq * sk / torch.tensor(scale, dtype=torch.float32, device=acc.device)
    s = torch.where(mask != 0, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / lane_order_sum(e)
    amax = p.abs().amax(dim=-1, keepdim=True)
    ps = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(p / ps), -128, 127).to(torch.int8), ps


def attn_fused_lut_ref(q, kt, v, sq, sk, sv, mask, table: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Plain version of ``attn_fused_lut``: both products gathered from
    ``table`` (256, 256) -> (G, M, P) float32."""
    qp, ps = softmax_requant(lut_matmul_ref(q, kt, table), sq, sk, mask, scale)
    return lut_matmul_ref(qp, v, table).float() * ps * sv


def attn_fused_inject_ref(inj: CompiledInjector, q, kt, v, sq, sk, sv, mask, scale: float, *,
                          max_pairs: int = MAX_PAIRS_PER_CHUNK) -> torch.Tensor:
    """Plain version of ``attn_fused_inject``: both products replayed on
    ``inj``'s circuit (``replay_matmul_ref``, at most ``max_pairs`` operand
    pairs at a time) -> (G, M, P) float32."""
    def idx(x):
        return x.to(torch.int32) + 128

    acc = replay_matmul_ref(inj, idx(q), idx(kt), max_pairs=max_pairs)
    qp, ps = softmax_requant(acc, sq, sk, mask, scale)
    return replay_matmul_ref(inj, idx(qp), idx(v), max_pairs=max_pairs).float() * ps * sv


def index_step(table: torch.Tensor) -> int:
    """The most an AMR product moves when its first operand moves one int8
    step: max |table[i + 1, j] - table[i, j]|."""
    return int((table[1:].long() - table[:-1].long()).abs().max())


def flip_tolerance(qp: torch.Tensor, qp_other: torch.Tensor, ps: torch.Tensor,
                   ps_other: torch.Tensor, sv: torch.Tensor, step: int,
                   want: torch.Tensor) -> torch.Tensor:
    """Bound on |out - out_other| (G, M, P) for two PV results over the same
    values whose int8 probabilities differ at some indices, each by one step.

    A row whose n indices differ moves its int32 sum by at most n * step;
    the scales ps may differ by float32 ulps, and the rescale rounds twice:
    ``(n * step * max(ps) + 2**-20 * |want| / sv) * sv``.
    """
    n = (qp != qp_other).sum(dim=-1, keepdim=True).float()
    return n * step * torch.maximum(ps, ps_other) * sv + 2.0 ** -20 * want.abs()
