"""Public fused-attention op: the AMR attention step as one kernel launch.

The port of the JAX package's ``kernels/attn_fused/ops.py``.
``fused_attention`` takes the seam's pre-folded operands, as
``models/attention._seam_scores`` / ``_seam_combine`` fold them: (G, M, D)
query rows (the GQA group folded into the rows), (G, D, T) transposed keys
and (G, T, P) values, with (batch, kv head) flattened to one group axis, and
an explicit (G, M, T) validity mask.  It quantizes here, with the seam's
front ends, and hands the kernel integer operands and float32 scales.

The kernels' bar is their plain versions, bit for bit (``ref.py``: the row
sum of the softmax runs in a fixed order on both routes).  Against the
unfused seam composition (``fused_attention_reference``, whose
``torch.softmax`` sums in an order PyTorch does not specify) the bar is a
tolerance: a re-quantized probability may flip by one int8 step, and a row
with n flips moves by at most n steps of the table (``ref.flip_tolerance``).

As in the JAX package, no model dispatches this op: the models run the
unfused seam.  The fused op computes its scores in float32, where the
models' bf16 chain rounds them to bf16, so it is a different function.

The tensor's device picks the route: CPU tensors run the plain versions,
CUDA tensors the kernels (or raise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.amr_matmul.ops import check_accumulation, kernel_table
from repro_torch.numerics import injection
from repro_torch.numerics.approx_matmul import AMRNumerics, approx_matmul
from repro_torch.numerics.quant import quantize_int8, quantize_int8_ste

from .kernel import attn_fused_inject, attn_fused_lut
from .ref import NEG_INF

METHODS = ("lut", "inject")


def _check_shapes(q, kt, v, mask):
    if q.dim() != 3 or kt.dim() != 3 or v.dim() != 3 or mask.dim() != 3:
        raise ValueError(
            f"fused_attention wants q (G,M,D), kt (G,D,T), v (G,T,P), mask "
            f"(G,M,T); got {tuple(q.shape)} / {tuple(kt.shape)} / {tuple(v.shape)} / "
            f"{tuple(mask.shape)}")
    G, M, D = q.shape
    T = kt.shape[-1]
    P = v.shape[-1]
    if tuple(kt.shape[:2]) != (G, D) or tuple(v.shape[:2]) != (G, T) \
            or tuple(mask.shape) != (G, M, T):
        raise ValueError(
            f"fused_attention operand shapes disagree: q {tuple(q.shape)}, "
            f"kt {tuple(kt.shape)}, v {tuple(v.shape)}, mask {tuple(mask.shape)} (want "
            f"matching G and D/T/P contractions)")
    return G, M, D, T, P


def quantize_operands(q, kt, v, method: str):
    """(q8, k8, v8, sq, sk, sv): int8 operands and float32 scales, contiguous,
    quantized per query row, per key column and per value column as the
    seam's front end of ``method`` does: ``quantize_int8`` for lut,
    ``quantize_int8_ste`` for inject.  For bfloat16 inputs the two give
    different indices (one divides in bfloat16, the other in float32); for
    float32 inputs they agree."""
    quant = quantize_int8 if method == "lut" else quantize_int8_ste
    out = []
    for x, axis in ((q, -1), (kt, -2), (v, -2)):
        qx, sx = quant(x, axis=axis)
        out.append((qx.to(torch.int8).contiguous(), sx.contiguous()))
    (q8, sq), (k8, sk), (v8, sv) = out
    return q8, k8, v8, sq, sk, sv


def fused_attention(q, kt, v, mask, *, border: int = 8, method: str = "lut",
                    schedule_ref: str | None = None, scale: float | None = None,
                    bm: int | None = None) -> torch.Tensor:
    """Fused QK^T -> masked softmax -> PV under AMR product semantics.

    ``q``: (G, M, D) query rows, ``kt``: (G, D, T) transposed keys, ``v``:
    (G, T, P) values (float32 or bfloat16), ``mask``: (G, M, T) bool/int
    validity (invalid columns take NEG_INF before the softmax).  ``scale``
    divides the scores (default sqrt(D), the seam's convention).
    ``method="lut"`` gathers the default design point's product table;
    ``method="inject"`` replays the reduction circuit, any registered
    schedule via ``schedule_ref`` (None = the paper's default for
    ``border``).  ``bm`` query rows per block (a divisor of M, checked by the
    kernel wrapper) change the time, never a bit.  Returns (G, M, P) float32.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    _, _, D, T, _ = _check_shapes(q, kt, v, mask)
    scale = float(D) ** 0.5 if scale is None else float(scale)
    mask = mask.to(torch.int32).contiguous()

    if method == "lut":
        if schedule_ref is not None:
            raise ValueError(
                "schedule_ref is an inject-method knob (the lut method "
                "tabulates the default design point for `border`); use "
                "method='inject' to run a registered schedule")
        for k_len, what in ((D, "QK^T"), (T, "PV")):
            check_accumulation(k_len, border, f"fused_attention {what}")
        q8, k8, v8, sq, sk, sv = quantize_operands(q, kt, v, method)
        return attn_fused_lut(q8, k8, v8, sq, sk, sv, mask, kernel_table(border, q.device),
                              scale=scale, bm=bm)

    inj = injection.get_injector(AMRNumerics("amr_inject", border=border,
                                             schedule_ref=schedule_ref))
    for k_len in (D, T):
        injection.check_accumulation_bound(inj, k_len, schedule=schedule_ref)
    q8, k8, v8, sq, sk, sv = quantize_operands(q, kt, v, method)
    return attn_fused_inject(inj, q8, k8, v8, sq, sk, sv, mask, scale=scale, bm=bm)


def _seam_numerics(border: int, method: str, schedule_ref: str | None) -> AMRNumerics:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "lut":
        if schedule_ref is not None:
            raise ValueError("schedule_ref requires method='inject'")
        return AMRNumerics("amr_kernel", border=border, rank=0)
    return AMRNumerics("amr_inject", border=border, schedule_ref=schedule_ref)


def reference_probabilities(q, kt, mask, *, border: int = 8, method: str = "lut",
                            schedule_ref: str | None = None,
                            scale: float | None = None) -> torch.Tensor:
    """The unfused seam's softmax rows (G, M, T), before ``attn.pv``
    quantizes them: ``approx_matmul`` at site ``attn.qk``, the rescale, the
    NEG_INF mask and ``torch.softmax``."""
    nm = _seam_numerics(border, method, schedule_ref)
    D = q.shape[-1]
    scale = float(D) ** 0.5 if scale is None else float(scale)
    scores = approx_matmul(q, kt, nm, site="attn.qk") / scale
    scores = torch.where(mask != 0, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def fused_attention_reference(q, kt, v, mask, *, border: int = 8, method: str = "lut",
                              schedule_ref: str | None = None,
                              scale: float | None = None) -> torch.Tensor:
    """The unfused seam composition the fused op is held to.

    The models/attention.py chain on pre-folded operands: a grouped
    ``approx_matmul`` at site ``attn.qk``, the sqrt(D) rescale, NEG_INF
    masking, ``torch.softmax``, and a grouped ``approx_matmul`` at site
    ``attn.pv``.  The lut method runs under ``amr_kernel`` at rank 0, whose
    bits are ``amr_lut``'s (the JAX reference's mode) and which takes the
    grouped gather kernel on the card; the inject method under
    ``amr_inject``.
    """
    nm = _seam_numerics(border, method, schedule_ref)
    probs = reference_probabilities(q, kt, mask, border=border, method=method,
                                    schedule_ref=schedule_ref, scale=scale)
    return approx_matmul(probs, v, nm, site="attn.pv")
