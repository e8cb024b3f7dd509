"""GQA/MQA attention with qk-norm, sliding windows, RoPE and a per-slot KV cache.

The port of the JAX package's ``models/attention.py``: self-attention
layers, global (``window`` 0) and sliding-window (``window`` > 0), and the
decoder's cross-attention to an encoder's output:

  * ``attend_full``    — training / forward over a whole sequence (causal;
    ``causal=False`` is the encoder's bidirectional form);
  * ``attend_prefill`` — the same, also building the decode KV cache;
  * ``attend_decode``  — one token per row against the cache;
  * ``encode_cross_kv`` / ``attend_cross`` — a decoder layer's K and V over
    the encoder frames (sites ``xattn.wk`` / ``xattn.wv``), and its queries
    against them.  Query and KV heads are equal there, so cross-attention
    runs the GQA helpers with group size 1 and shares the ``attn.qk`` /
    ``attn.pv`` sites with self-attention, as in the JAX package.

Cache layout: (batch, capacity, n_kv, head_dim).  A sliding-window layer's
cache is a ring: token t lives at slot t % capacity, and once the ring is
full every slot is live.  Under an approximate numerics policy the score
(``attn.qk``) and value (``attn.pv``) contractions go through the numerics
seam with the GQA group folded into the row dim; exact numerics keep the
plain einsums, one request at a time (``approx_matmul.per_request``).  A
causal prompt of ``_CHUNKED_THRESHOLD`` tokens or more whose length is a
multiple of ``_Q_CHUNK`` runs in query blocks (``_chunked_attention``), as
the JAX package's does; every other length runs in one block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.numerics import AMRNumerics, approx_matmul, resolve_numerics
from repro_torch.numerics.approx_matmul import per_request

from .layers import apply_rope, dense, rms_norm

NEG_INF = -2.0e38
_Q_CHUNK = 2048             # query-block size of chunked attention
_CHUNKED_THRESHOLD = 16384  # chunked attention from this prompt length (the JAX package's)


def _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta, qk_norm,
                 numerics, eps: float):
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


def _gqa_scores(q, k, numerics=None):
    """q: (B, S, Hq, D), k: (B, T, Hkv, D) -> (B, Hq, S, T); a policy
    resolves at site ``attn.qk``; exact, one product per request."""
    numerics = resolve_numerics(numerics, "attn.qk")
    if numerics is not None and not numerics.is_exact():
        return _seam_scores(q, k, numerics)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scores = per_request(lambda a, b: torch.einsum("bskgd,btkd->bkgst", a, b),
                         q.reshape(B, S, Hkv, g, D), k) / (D ** 0.5)
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


def _gqa_combine(probs, v, numerics=None):
    """probs: (B, Hq, S, T), v: (B, T, Hkv, D) -> (B, S, Hq, D); a policy
    resolves at site ``attn.pv``; exact, one product per request."""
    numerics = resolve_numerics(numerics, "attn.pv")
    if numerics is not None and not numerics.is_exact():
        return _seam_combine(probs, v, numerics)
    B, Hq, S, T = probs.shape
    Hkv = v.shape[2]
    g = Hq // Hkv
    out = per_request(lambda a, b: torch.einsum("bkgst,btkd->bskgd", a, b),
                      probs.reshape(B, Hkv, g, S, T), v)
    return out.reshape(B, S, Hq, v.shape[-1])


def takes_chunked_path(S: int) -> bool:
    """Whether a causal prompt of S tokens runs in query blocks: the JAX
    package's condition, S >= 16384 and a whole number of 2048-token blocks."""
    return S >= _CHUNKED_THRESHOLD and S % _Q_CHUNK == 0


def _attend_rows(q, k, v, rows, window: int, dtype, numerics):
    """Queries q (B, Sq, Hq, D) at positions ``rows`` (Sq,) against all of k
    and v (B, S, Hkv, D): causal, and within ``window`` when it is > 0."""
    cols = torch.arange(k.shape[1], device=q.device)
    mask = cols[None, :] <= rows[:, None]
    if window > 0:
        mask &= (rows[:, None] - cols[None, :]) < window
    scores = _gqa_scores(q, k, numerics).float()
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_combine(probs, v, numerics)


def _chunked_attention(q, k, v, window: int, dtype, numerics):
    """Query-block attention (JAX ``_chunked_attention``): blocks of
    ``_Q_CHUNK`` queries against the whole of K and V, so that no S x S
    score matrix is held; the Python loop stands for ``lax.scan``.  Each
    block's products go through the numerics seam.  Queries quantize per
    row and K, V per column over the same D and S as in one block, so the
    integer products are those of ``_attend_rows`` over all of S."""
    S = q.shape[1]
    outs = [_attend_rows(q[:, i:i + _Q_CHUNK], k, v,
                         torch.arange(i, i + _Q_CHUNK, device=q.device), window, dtype,
                         numerics)
            for i in range(0, S, _Q_CHUNK)]
    return torch.cat(outs, dim=1)


def _causal_attention(q, k, v, window: int, dtype, numerics):
    S = q.shape[1]
    if takes_chunked_path(S):
        return _chunked_attention(q, k, v, window, dtype, numerics)
    return _attend_rows(q, k, v, torch.arange(S, device=q.device), window, dtype, numerics)


def _bidirectional_attention(q, k, v, dtype, numerics):
    """Every query against every key: the JAX package's all-true mask, in
    one block at any length."""
    scores = _gqa_scores(q, k, numerics).float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_combine(probs, v, numerics)


def attend_full(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                theta: float, qk_norm: bool = False, window: int = 0, causal: bool = True,
                numerics=None, eps: float = 1e-6) -> torch.Tensor:
    """Self-attention over the full sequence: causal, within ``window``
    tokens when it is > 0; ``causal=False`` gives the bidirectional form of
    an encoder stack (never the chunked path, as in the JAX package)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, numerics, eps)
    if causal:
        out = _causal_attention(q, k, v, window, x.dtype, numerics)
    else:
        out = _bidirectional_attention(q, k, v, x.dtype, numerics)
    return dense(out.reshape(B, S, n_heads * head_dim), params["wo"], numerics,
                 site="attn.wo")


def cross_attention_specs(d_model: int, n_heads: int, head_dim: int, dtype, shape) -> dict:
    """The JAX package's ``init_cross_attention`` leaves as (shape, dtype,
    std) specs: ``wq``, ``wk``, ``wv`` (D, H Dh) and ``wo`` (H Dh, D), with
    as many KV heads as query heads; ``shape`` adds the layer stacking."""
    HD = n_heads * head_dim
    return {
        "wq": (shape(d_model, HD), dtype, d_model ** -0.5),
        "wk": (shape(d_model, HD), dtype, d_model ** -0.5),
        "wv": (shape(d_model, HD), dtype, d_model ** -0.5),
        "wo": (shape(HD, d_model), dtype, HD ** -0.5),
    }


def encode_cross_kv(params: dict, enc_out: torch.Tensor, *, n_heads: int, head_dim: int,
                    numerics=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's K and V (B, T, H, Dh) over the encoder output
    enc_out (B, T, D), at the sites ``xattn.wk`` and ``xattn.wv``."""
    B, T, _ = enc_out.shape
    k = dense(enc_out, params["wk"], numerics, site="xattn.wk").reshape(B, T, n_heads, head_dim)
    v = dense(enc_out, params["wv"], numerics, site="xattn.wv").reshape(B, T, n_heads, head_dim)
    return k, v


def attend_cross(params: dict, x: torch.Tensor, enc_kv: tuple[torch.Tensor, torch.Tensor], *,
                 n_heads: int, head_dim: int, numerics=None) -> torch.Tensor:
    """Decoder cross-attention, x (B, S, D) against ``enc_kv`` (K, V from
    ``encode_cross_kv``), unmasked; the queries at ``xattn.wq``, the output
    at ``xattn.wo``, the products at ``attn.qk`` / ``attn.pv``."""
    B, S, _ = x.shape
    q = dense(x, params["wq"], numerics, site="xattn.wq").reshape(B, S, n_heads, head_dim)
    k, v = enc_kv
    out = _bidirectional_attention(q, k, v, x.dtype, numerics)
    return dense(out.reshape(B, S, n_heads * head_dim), params["wo"], numerics, site="xattn.wo")


@dataclasses.dataclass
class KVCache:
    """KV cache, ring-buffered for sliding-window layers; ``length`` =
    logical tokens written so far.

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
                  head_dim: int, theta: float, qk_norm: bool = False, window: int = 0,
                  numerics=None,
                  eps: float = 1e-6) -> tuple[torch.Tensor, KVCache]:
    """One decode step, x: (B, 1, d_model): write K/V at each row's cache
    slot, attend over the valid slots.  A sliding-window layer (``window``
    > 0) writes slot pos % C and, once its ring is full, attends over every
    slot; a global layer writes slot min(pos, C - 1).  All position math is
    row-wise, so a batched step computes what each request's solo decode
    would."""
    B = x.shape[0]
    C = cache.k.shape[1]
    pos_b = cache.length.to(torch.int32).expand(B)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, pos_b[:, None], theta,
                           qk_norm, numerics, eps)
    slot = pos_b % C if window > 0 else torch.clamp(pos_b, max=C - 1)
    # masked select rather than an indexed write: the new cache is a fresh
    # tensor, as the JAX package's functional update is
    hit = (torch.arange(C, device=x.device)[None, :] == slot[:, None])[:, :, None, None]
    new_k = torch.where(hit, k.to(cache.k.dtype), cache.k)
    new_v = torch.where(hit, v.to(cache.v.dtype), cache.v)

    scores = _gqa_scores(q, new_k, numerics).float()            # (B, Hq, 1, C)
    valid = torch.arange(C, device=x.device)[None, :] <= slot[:, None]
    if window > 0:
        valid |= pos_b[:, None] >= C  # a full ring: every slot is live
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_combine(probs, new_v, numerics).reshape(B, 1, n_heads * head_dim)
    out = dense(out, params["wo"], numerics, site="attn.wo")
    return out, KVCache(new_k, new_v, cache.length + 1)


def attend_prefill(params: dict, x: torch.Tensor, capacity: int, *, n_heads: int, n_kv: int,
                   head_dim: int, theta: float, qk_norm: bool = False, window: int = 0,
                   numerics=None,
                   eps: float = 1e-6) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also builds the decode KV cache, handing
    the prompt over to decode.  A global layer needs capacity >= S and pads;
    a sliding-window layer whose capacity C (its ring) is at most S keeps
    the last C tokens, token t at slot t % C."""
    B, S, _ = x.shape
    if capacity < S and window <= 0:
        raise ValueError(f"cache capacity {capacity} is shorter than the prompt ({S})")
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, numerics, eps)
    out = _causal_attention(q, k, v, window, x.dtype, numerics)
    out = dense(out.reshape(B, S, n_heads * head_dim), params["wo"], numerics, site="attn.wo")
    C = capacity
    if window > 0 and C <= S:
        k_c = torch.roll(k[:, -C:], S % C, dims=1)
        v_c = torch.roll(v[:, -C:], S % C, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, C - S)
        k_c, v_c = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return out, KVCache(k_c, v_c, torch.tensor(S, dtype=torch.int32, device=x.device))
