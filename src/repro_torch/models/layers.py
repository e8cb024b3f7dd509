"""Common layers: norms, rotary embeddings, MLPs — plain functions on tensors.

The port of the JAX package's ``models/layers.py``.  Every weight matmul
goes through the numerics policy (``dense``), which is how the paper's
approximate multiplier enters the model; the LM head stays exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rms_norm.kernel import mean_square
from repro_torch.numerics import approx_matmul, resolve_numerics
from repro_torch.numerics.approx_matmul import matmul_exact


def dense(x: torch.Tensor, w: torch.Tensor, numerics=None, site: str | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) under the numerics policy, in x's dtype.

    ``site`` labels the call site (e.g. ``"mlp.w_gate"``); a site-resolved
    policy resolves here against it and the ambient layer.  x keeps its
    leading (request) dims, so the float products that run one request a
    call (``approx_matmul.per_request``) see them.
    """
    numerics = resolve_numerics(numerics, site)
    if numerics is None or numerics.is_exact():
        return matmul_exact(x, w)
    return approx_matmul(x, w, numerics, site=site).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in float32, back in x's dtype.  The mean
    square is the row kernel's on CUDA (``kernels.rms_norm``): a row sums in
    the same order in any batch, so a served request's norm is the same
    alone and batched."""
    dtype = x.dtype
    x = x.float()
    out = x * torch.rsqrt(mean_square(x) + eps) * (1.0 + scale.float())
    return out.to(dtype)


# ----------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLP
_ACTS = {
    "geglu": lambda g, u: F.gelu(g, approximate="tanh") * u,
    "swiglu": lambda g, u: F.silu(g) * u,
    "gelu": lambda g, u: F.gelu(g + u, approximate="tanh"),
}


def mlp(params: dict, x: torch.Tensor, act: str, numerics) -> torch.Tensor:
    if act not in _ACTS:
        raise ValueError(f"unknown mlp activation {act!r}; known: {tuple(_ACTS)}")
    g = dense(x, params["w_gate"], numerics, site="mlp.w_gate")
    u = dense(x, params["w_up"], numerics, site="mlp.w_up")
    return dense(_ACTS[act](g, u), params["w_down"], numerics, site="mlp.w_down")


# -------------------------------------------------------------- embeddings
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits with the tied table, kept exact: the LM head dominates the
    vocab-scaled error and the paper's technique targets inner matmuls.
    One product per request, so a request's logits do not depend on the batch."""
    return matmul_exact(x, table.T.to(x.dtype))
