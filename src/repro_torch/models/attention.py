"""GQA/MQA attention with qk-norm, RoPE and a per-slot KV cache.

The port of the JAX package's ``models/attention.py`` for full (global)
attention layers:

  * ``attend_full``    — training / forward over a whole sequence (causal);
  * ``attend_prefill`` — the same, also building the decode KV cache;
  * ``attend_decode``  — one token per row against the cache.

Cache layout: (batch, capacity, n_kv, head_dim).  Under an approximate
numerics policy the score (``attn.qk``) and value (``attn.pv``)
contractions go through the numerics seam with the GQA group folded into
the row dim; exact numerics keep the plain einsums.  Sliding-window layers
and the chunked long-prompt path (prompts of 16384 tokens and more) are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.numerics import AMRNumerics, approx_matmul

from .layers import apply_rope, dense, rms_norm

NEG_INF = -2.0e38
_CHUNKED_THRESHOLD = 16384  # the JAX package switches to chunked attention here


def _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta, qk_norm,
                 numerics: AMRNumerics | None, eps: float):
    B, S, _ = x.shape
    q = dense(x, params["wq"], numerics, site="attn.wq").reshape(B, S, n_heads, head_dim)
    k = dense(x, params["wk"], numerics, site="attn.wk").reshape(B, S, n_kv, head_dim)
    v = dense(x, params["wv"], numerics, site="attn.wv").reshape(B, S, n_kv, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _seam_scores(q, k, numerics: AMRNumerics):
    """QK^T through the numerics seam (``attn.qk``).

    Folds the GQA group into the row dim — one batched call
    (B, Hkv, g*S, D) @ (B, Hkv, D, T) — so each row quantizes per (batch,
    kv head, group, query) and a slot-batched decode row quantizes exactly
    as its solo decode would.  The division by sqrt(D) follows the seam.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qa = q.reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4).reshape(B, Hkv, g * S, D)
    kb = k.permute(0, 2, 3, 1)                                  # (B, Hkv, D, T)
    scores = approx_matmul(qa, kb, numerics, site="attn.qk") / (D ** 0.5)
    return scores.reshape(B, Hq, S, T)


def _gqa_scores(q, k, numerics: AMRNumerics | None = None):
    """q: (B, S, Hq, D), k: (B, T, Hkv, D) -> (B, Hq, S, T)."""
    if numerics is not None and not numerics.is_exact():
        return _seam_scores(q, k, numerics)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scores = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, Hkv, g, D), k) / (D ** 0.5)
    return scores.reshape(B, Hkv * g, S, k.shape[1])


def _seam_combine(probs, v, numerics: AMRNumerics):
    """PV through the seam (``attn.pv``): (B, Hkv, g*S, T) @ (B, Hkv, T, D),
    folded as in ``_seam_scores``; the result is cast to probs' dtype."""
    B, Hq, S, T = probs.shape
    Hkv, D = v.shape[2], v.shape[3]
    g = Hq // Hkv
    pa = probs.reshape(B, Hkv, g * S, T)
    vb = v.permute(0, 2, 1, 3)                                  # (B, Hkv, T, D)
    out = approx_matmul(pa, vb, numerics, site="attn.pv")
    out = out.reshape(B, Hkv, g, S, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, Hq, D).to(probs.dtype)


def _gqa_combine(probs, v, numerics: AMRNumerics | None = None):
    """probs: (B, Hq, S, T), v: (B, T, Hkv, D) -> (B, S, Hq, D)."""
    if numerics is not None and not numerics.is_exact():
        return _seam_combine(probs, v, numerics)
    B, Hq, S, T = probs.shape
    Hkv = v.shape[2]
    g = Hq // Hkv
    out = torch.einsum("bkgst,btkd->bskgd", probs.reshape(B, Hkv, g, S, T), v)
    return out.reshape(B, S, Hq, v.shape[-1])


def _causal_attention(q, k, v, dtype, numerics):
    S = q.shape[1]
    if S >= _CHUNKED_THRESHOLD:
        raise NotImplementedError(
            f"prompts of {_CHUNKED_THRESHOLD} tokens and more take the chunked attention "
            f"path, which is not ported yet (got {S})")
    scores = _gqa_scores(q, k, numerics).float()
    idx = torch.arange(S, device=q.device)
    mask = idx[None, :] <= idx[:, None]
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_combine(probs, v, numerics)


def attend_full(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                theta: float, qk_norm: bool = False, numerics: AMRNumerics | None = None,
                eps: float = 1e-6) -> torch.Tensor:
    """Causal self-attention over the full sequence."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, numerics, eps)
    out = _causal_attention(q, k, v, x.dtype, numerics)
    return dense(out.reshape(B, S, n_heads * head_dim), params["wo"], numerics,
                 site="attn.wo")


@dataclasses.dataclass
class KVCache:
    """KV cache; ``length`` = logical tokens written so far.

    ``length`` is a scalar (one shared position) or a (B,) vector of
    per-slot positions (continuous batching: each row is a request admitted
    at its own time).  The decode math broadcasts over both.
    """

    k: torch.Tensor       # (B, C, n_kv, D)
    v: torch.Tensor
    length: torch.Tensor  # () or (B,) int32

    @classmethod
    def zeros(cls, batch, capacity, n_kv, head_dim, dtype, device, per_slot=False):
        shape = (batch, capacity, n_kv, head_dim)
        length = torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), length)


def attend_decode(params: dict, x: torch.Tensor, cache: KVCache, *, n_heads: int, n_kv: int,
                  head_dim: int, theta: float, qk_norm: bool = False,
                  numerics: AMRNumerics | None = None,
                  eps: float = 1e-6) -> tuple[torch.Tensor, KVCache]:
    """One decode step, x: (B, 1, d_model): write K/V at each row's cache
    slot, attend over the valid slots.  All position math is row-wise, so a
    batched step computes what each request's solo decode would."""
    B = x.shape[0]
    C = cache.k.shape[1]
    pos_b = cache.length.to(torch.int32).expand(B)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, pos_b[:, None], theta,
                           qk_norm, numerics, eps)
    slot = torch.clamp(pos_b, max=C - 1)
    # masked select rather than an indexed write: the new cache is a fresh
    # tensor, as the JAX package's functional update is
    hit = (torch.arange(C, device=x.device)[None, :] == slot[:, None])[:, :, None, None]
    new_k = torch.where(hit, k.to(cache.k.dtype), cache.k)
    new_v = torch.where(hit, v.to(cache.v.dtype), cache.v)

    scores = _gqa_scores(q, new_k, numerics).float()            # (B, Hq, 1, C)
    valid = torch.arange(C, device=x.device)[None, :] <= slot[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_combine(probs, new_v, numerics).reshape(B, 1, n_heads * head_dim)
    out = dense(out, params["wo"], numerics, site="attn.wo")
    return out, KVCache(new_k, new_v, cache.length + 1)


def attend_prefill(params: dict, x: torch.Tensor, capacity: int, *, n_heads: int, n_kv: int,
                   head_dim: int, theta: float, qk_norm: bool = False,
                   numerics: AMRNumerics | None = None,
                   eps: float = 1e-6) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also builds the decode KV cache
    (capacity >= S), handing the prompt over to decode."""
    B, S, _ = x.shape
    if capacity < S:
        raise ValueError(f"cache capacity {capacity} is shorter than the prompt ({S})")
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, numerics, eps)
    out = _causal_attention(q, k, v, x.dtype, numerics)
    out = dense(out.reshape(B, S, n_heads * head_dim), params["wo"], numerics, site="attn.wo")
    pad = (0, 0, 0, 0, 0, capacity - S)
    cache = KVCache(torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
                    torch.tensor(S, dtype=torch.int32, device=x.device))
    return out, cache
