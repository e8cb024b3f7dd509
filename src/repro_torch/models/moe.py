"""Mixture-of-Experts with sorted-capacity dispatch (GShard/Switch style).

The port of the JAX package's ``models/moe.py``.  Tokens are routed top-k
by an exact float32 router, sorted by expert id (a stable sort), and
scattered into fixed (E, C, D) capacity buffers; the expert FFNs run as one
grouped product per projection, (E, C, D) @ (E, D, F); the outputs are
combined by a weighted sum over each token's experts.  Overflow beyond the
capacity drops, as in the JAX package.

Two forms, by ``MoEConfig.dispatch_shard``:

* ``"local"`` (``_moe_forward_local``): the JAX package's shard-local
  dispatch on the whole array, its route without a mesh — exact expert
  products in ``x``'s dtype, the numerics ignored, as JAX's
  ``_moe_local_body`` ignores them.  The registered dbrx-132b and
  moonshot-v1-16b-a3b take it.
* every other value (``_moe_forward_global``, the ``MoEConfig`` default
  ``"replicate"``): each projection is one grouped ``approx_matmul`` at the
  sites ``moe.expert.w_gate`` / ``w_up`` / ``w_down`` (a per-layer policy's
  ``"moe.expert"`` entry resolves all three), cast to ``x``'s dtype.  At
  rank 0 that is the grouped gather kernel, under ``amr_inject`` the
  grouped replay kernel, at rank > 0 one float32 product per expert.

**The same bits alone or batched.**  The router runs one float32 product
per request (``matmul_exact``).  Where every token fits the dropless
capacity (T·K <= 4096: C = T·K, nothing drops, and each token's output
depends on its own row alone), the layer dispatches one request at a time,
so the capacity buffer and every expert product have the shape a solo call
gives them (float products may sum a row in another order at another
shape); each request's dispatch runs in its ``request_scope``, which gives
``amr_noise`` the request's own stream.  Above that the layer dispatches
the batch at once, with the JAX package's capacity and drops.  The combine
adds each token's K contributions in ascending expert id, rounding to
``x``'s dtype after each add (the order of the JAX package's scatter-add
over the sorted list), with no atomic ``index_add_``.

**The same bits on every backward pass.**  The scatter into the capacity
buffer and the combine's gather out of it are row gathers whose backward
passes sum in a fixed order (``_GatherRows``): a token's gradient adds its
K buffer rows' gradients in ascending expert id from zero (the mirror of
the combine, and the order of the JAX package's scatter-add), and a buffer
row's gradient is the one route it came from.  A dropped route reads and
writes a zero row of its own.  Where another backward of the layer
scatters (the top-k's sort, the weights' reorder by expert id), each
place receives one value; no backward adds two floats into one place in
an order the hardware picks, so two backward passes on the card, and a
training run restarted from a checkpoint, give the same bits.

The router and the top-k stay exact: routing decisions are sensitive to
small logit changes, and the paper's technique targets the bulk matmuls.
Ties among equal probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.numerics import approx_matmul
from repro_torch.numerics.approx_matmul import matmul_exact
from repro_torch.numerics.context import request_scope

SITES = ("moe.expert.w_gate", "moe.expert.w_up", "moe.expert.w_down")
DROPLESS_MAX = 4096  # T * K at or below it: dropless capacity C = T * K


def moe_param_specs(d_model: int, cfg: MoEConfig, dtype: torch.dtype, shape) -> dict:
    """The JAX package's ``init_moe`` leaves as (shape, dtype, std) specs:
    the router float32 (D, E), ``w_gate`` and ``w_up`` (E, D, F), ``w_down``
    (E, F, D); ``shape`` adds the layer stacking."""
    E, F_ = cfg.n_experts, cfg.d_ff_expert
    return {
        "router": (shape(d_model, E), torch.float32, d_model ** -0.5),
        "w_gate": (shape(E, d_model, F_), dtype, d_model ** -0.5),
        "w_up": (shape(E, d_model, F_), dtype, d_model ** -0.5),
        "w_down": (shape(E, F_, d_model), dtype, F_ ** -0.5),
    }


def capacity(n_assign: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert for ``n_assign`` = T * K assignments: dropless (C =
    T * K) up to ``DROPLESS_MAX``, else the JAX package's
    max(int(T K cf / E + 0.999), 1)."""
    if n_assign <= DROPLESS_MAX:
        return n_assign
    return max(int(n_assign * capacity_factor / n_experts + 0.999), 1)


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x (B, S, D) -> (top_w (T, K) float32, top_e (T, K) int64, aux): the
    exact float32 router, one product per request; softmax; the top K by a
    stable descending sort (ties to the lower expert id); the weights
    renormalized; the Switch load-balancing loss E * sum_e f_e p_e."""
    B, S, _ = x.shape
    E = router.shape[-1]
    T = B * S
    logits = matmul_exact(x.float(), router).reshape(T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * top_k)
    aux = E * torch.sum(me * ce)
    return top_w, top_e, aux


def _experts(params: dict, xbuf: torch.Tensor, numerics) -> torch.Tensor:
    """The expert FFNs on the capacity buffer (E, C, D) -> (E, C, D): exact
    products in its dtype, or each projection one grouped ``approx_matmul``
    under ``numerics``."""
    dtype = xbuf.dtype
    if numerics is None or numerics.is_exact():
        g = torch.matmul(xbuf, params["w_gate"])
        u = torch.matmul(xbuf, params["w_up"])
        return torch.matmul((F.silu(g) * u).to(dtype), params["w_down"])

    def mm(a, w, site):
        return approx_matmul(a, w, numerics, site=site).to(dtype)

    g = mm(xbuf, params["w_gate"], SITES[0])
    u = mm(xbuf, params["w_up"], SITES[1])
    return mm((F.silu(g) * u).to(dtype), params["w_down"], SITES[2])


class _GatherRows(torch.autograd.Function):
    """``out = src_pad[idx]``, rows of ``src`` (N, D) with a zero row N
    appended, whose backward sums by construction in a fixed order: row n
    of the gradient is ``sum_j g_pad[back[n, j]]``, added in ascending j
    from zero, where ``back`` (N, J) lists the output rows that read source
    row n (the zero row of ``g_pad`` where fewer did).  No atomic add and
    no accumulating ``index_put``: two backward passes give the same bits
    on any device."""

    @staticmethod
    def forward(ctx, src, idx, back):
        ctx.save_for_backward(back)
        return F.pad(src, (0, 0, 0, 1))[idx]

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        rows = F.pad(g, (0, 0, 0, 1))[back]                         # (N, J, D)
        out = torch.zeros_like(rows[:, 0])
        for j in range(rows.shape[1]):
            out = out + rows[:, j]
        return out, None, None


def _dispatch(params: dict, xf: torch.Tensor, top_w: torch.Tensor, top_e: torch.Tensor,
              capacity_factor: float, numerics) -> torch.Tensor:
    """Sorted-capacity dispatch of T tokens xf (T, D) with their routes:
    scatter into (E, C, D), the experts, the weighted combine -> (T, D).

    Token t's k-th route in ascending expert id takes buffer row e C + p
    (p its slot: the tokens of an expert take its slots in token order, as
    the JAX package's stable sort by expert gives them), or none where p
    >= C (dropped).  The scatter and the combine are both row gathers
    (``_GatherRows``), each the other's inverse map: the scatter's backward
    adds a token's K rows in ascending expert id, the order the forward's
    combine adds them in."""
    T, D = xf.shape
    K = top_e.shape[-1]
    E = params["router"].shape[-1]
    C = capacity(T * K, E, capacity_factor)
    dev = xf.device
    top_e, asc = torch.sort(top_e, dim=-1, stable=True)             # ascending expert id
    top_w = torch.gather(top_w, 1, asc)
    fid = top_e.reshape(-1)
    order = torch.argsort(fid, stable=True)                         # by expert, then token
    counts = torch.bincount(fid, minlength=E)
    pos = torch.empty_like(fid)
    pos[order] = torch.arange(T * K, device=dev) - (torch.cumsum(counts, 0) - counts)[fid[order]]
    keep = (pos < C).reshape(T, K)
    row = torch.where(keep.reshape(-1), fid * C + pos, E * C)        # (T K,): E C = none
    # buffer row -> the token it holds (T: empty), and the flat route it came from
    holder = torch.full((E * C + 1,), T * K, dtype=torch.long, device=dev)
    holder[row] = torch.arange(T * K, device=dev)
    holder = holder[:E * C]
    token = torch.where(holder < T * K, holder // K, T)
    xbuf = _GatherRows.apply(xf, token, row.reshape(T, K)).reshape(E, C, D)
    ybuf = _experts(params, xbuf, numerics).reshape(E * C, D)
    y = _GatherRows.apply(ybuf, row, holder[:, None]).reshape(T, K, D)
    y = y * (top_w * keep).to(xf.dtype)[..., None]
    out = xf.new_zeros((T, D))
    for k in range(K):
        out = out + y[:, k]
    return out


def _moe(params: dict, x: torch.Tensor, cfg: MoEConfig, capacity_factor: float,
         numerics) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    top_w, top_e, aux = route(params["router"], x, cfg.top_k)
    if B > 1 and B * S * cfg.top_k <= DROPLESS_MAX:
        outs = []
        for r in range(B):
            rows = slice(r * S, (r + 1) * S)
            with request_scope(r, B):
                outs.append(_dispatch(params, x[r], top_w[rows], top_e[rows],
                                      capacity_factor, numerics))
        return torch.stack(outs), aux
    out = _dispatch(params, x.reshape(B * S, D), top_w, top_e, capacity_factor, numerics)
    return out.reshape(B, S, D), aux


def _moe_forward_global(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                        capacity_factor: float = 1.25, numerics=None):
    """The expert products through the numerics policy."""
    return _moe(params, x, cfg, capacity_factor, numerics)


def _moe_forward_local(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                       capacity_factor: float = 1.25, numerics=None):
    """The JAX package's shard-local dispatch on the whole array (its route
    without a mesh): exact expert products; ``numerics`` is ignored."""
    del numerics
    return _moe(params, x, cfg, capacity_factor, None)


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                capacity_factor: float = 1.25, numerics=None):
    """x (B, S, D) -> (output (B, S, D), aux load-balancing loss, float32)."""
    if cfg.dispatch_shard == "local":
        return _moe_forward_local(params, x, cfg, capacity_factor=capacity_factor,
                                  numerics=numerics)
    return _moe_forward_global(params, x, cfg, capacity_factor=capacity_factor,
                               numerics=numerics)
