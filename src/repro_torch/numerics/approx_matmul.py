"""Approximate matmul modes: the AMR-MUL as a numerics policy.

The port of the JAX package's ``numerics/approx_matmul.py``:

  exact       — ``torch.matmul`` in the requested dtype (baseline).
  amr_lut     — bit-exact AMR-MUL semantics per scalar product: int8
                quantize, per-element gather from the 256x256 table,
                integer accumulation.  The plain oracle (small shapes).
  amr_inject  — exact AMR products of any schedule, DSE candidates
                included (``schedule_ref``), by replaying the reduction
                circuit: the hand-written kernel of kernels/inject_replay.
  amr_lowrank — C = (A@B + U(A)@V(B)) * scales with rank-r SVD factors of
                the table's error, one float32 product over an augmented K.
  amr_noise   — training-scale surrogate: the exact product of the int8
                operands plus Gaussian error with the moments of the AMR
                error table (``lut.error_stats``), drawn from a generator
                seeded per call site, layer, step and unit
                (``context.noise_key``).
  amr_kernel  — the hand-written CUDA kernels (kernels/amr_matmul): the
                low-rank kernel at ``rank``, or the bit-exact full-table
                gather kernel when ``rank == 0``.

All functions take A: (..., M, K) and B: (K, N) or a batched B: (..., K, N)
whose leading dims broadcast against A's.  Quantization is per row of A
and per column of B, so a batched call equals stacking the per-group calls.

Dispatch goes through the mode registry (``numerics/registry.py``): each
mode registers at the bottom of this module, in the JAX package's order,
and ``AMRNumerics`` validates against the registry at construction;
callers never compare mode names.

Training: ``amr_inject``, ``amr_lowrank`` and ``amr_kernel`` are
``torch.autograd.Function``s whose forward runs the mode on detached
operands (the kernels on the card) and whose backward is the JAX
package's straight-through surrogate, the full-precision matmul's
gradient (``_lowrank_bwd``).  ``amr_lut`` differentiates through its
scales alone, as the JAX package's hard quantizer does, and ``amr_noise``
by plain autograd through the straight-through quantizer and the exact
product, as JAX differentiates ``matmul_amr_noise``.  Without grad
(serving) the forward runs as it is, with no autograd node.

Float products whose rows belong to different requests (the exact matmul
on a 2-D weight and ``amr_lowrank``'s flat form, split along A's leading
request dim, and the float32 low-rank product of the grouped attention
sites, split by group) run one request or one group per
``torch.matmul``, so a request's result does not depend on how many
requests share the step: batched and solo decode give the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.kernels.amr_matmul.ref import lut_matmul_ref

from . import registry
from .context import _value, current_scope, noise_key
from .quant import quantize_int8, quantize_int8_ste


@dataclasses.dataclass(frozen=True)
class AMRNumerics:
    """Numerics policy threaded through the model; validated against the
    mode registry at construction."""

    mode: str = "exact"
    border: int = 8  # approximate border column (paper Table I/II)
    rank: int = 8    # low-rank error rank; 0 in amr_kernel selects the full-LUT kernel
    noise_seed: int = 0  # amr_noise: the root of its PRNG keys (context.root_key)
    # amr_inject: handle of a registered custom schedule (DSE candidate) from
    # numerics.injection.register_schedule; None = the paper's schedule for
    # (n_digits=2, border).
    schedule_ref: str | None = None

    def __post_init__(self):
        registry.validate_policy(self)

    def is_exact(self) -> bool:
        return registry.get_mode(self.mode).exact


def per_request(fn, *ts: torch.Tensor):
    """``fn`` over each request of ``ts`` (their leading index), on fresh
    copies, its results joined along that index: the port's one rule for a
    float product of a batch of requests (the exact dense sites, the exact
    attention products, the SSM's exact readout).

    BLAS picks a call's algorithm by its shape and alignment, so a product
    over the whole batch may sum a request's row in another order than the
    request alone; one call a request, on a fresh copy, is the call a solo
    request makes.  ``fn`` keeps the leading dim of 1; it may return a
    tuple, joined part by part.  The norms need no split: their reduction
    is a kernel whose order a row's length alone fixes
    (``kernels.rms_norm``).
    """
    outs = [fn(*(t[i:i + 1].clone() for t in ts)) for i in range(ts[0].shape[0])]
    if not outs:
        return fn(*ts)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in the operands' dtype; on a 2-D B with A's leading
    dims (a request's tokens) one (M, K) @ (K, N) call per slice of them
    (``per_request``): a prefill (one request) stays one call, a decode
    step is one call per request."""
    if b.dim() != 2 or a.dim() <= 2:
        return torch.matmul(a, b)
    a3 = a.reshape(-1, *a.shape[-2:])
    out = per_request(lambda r: torch.matmul(r[0], b)[None], a3)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _lut_matmul(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor, max_abs: int,
                what: str, quantizer=quantize_int8) -> torch.Tensor:
    """The plain gather's matmul (JAX ``_lut_matmul``): quantize, gather
    from ``table``, sum in integers, rescale.

    ``quantizer`` is the int8 front end: ``quantize_int8`` (the amr_lut
    mode) or ``quantize_int8_ste`` (the inject path's, which its audit
    oracle must share: on bf16 inputs the two round differently).  Raises
    ``ValueError`` when K * max|product| could saturate int32, the guard the
    inject path applies, so both reject the same shapes.
    """
    from repro_torch.kernels.amr_matmul.ops import check_max_abs  # lazy: import cycle

    check_max_abs(a.shape[-1], max_abs, what)
    qa, sa = quantizer(a, axis=-1)
    qb, sb = quantizer(b, axis=-2)
    acc = lut_matmul_ref(qa.detach(), qb.detach(), table).float()
    return acc * sa * sb


def matmul_amr_lut(a: torch.Tensor, b: torch.Tensor, border: int) -> torch.Tensor:
    """Bit-exact AMR-MUL matmul via the plain gather (oracle; small shapes).

    Raises ``ValueError`` when K * max|product| could saturate int32, as the
    JAX package's oracle does.
    """
    return _lut_matmul(a, b, lut_lib.table_tensor(border, a.device),
                       lut_lib.table_max_abs(border), f"amr_lut(border={border})")


def _lowrank_fwd(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    """Augmented-K product with bf16 error lanes and float32 accumulation:
    (..., M, K) @ (K, N) one ``torch.matmul`` per request (slice of A's
    leading dims), grouped (G, M, K) @ (G, K, N) one per group.

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
    a_aug = a_aug.reshape(*a.shape[:-1], K * (1 + rank)).float()
    b_aug = torch.cat([qb[..., :, None, :].to(torch.bfloat16), vb.movedim(-1, -2)], dim=-2)
    b_aug = b_aug.reshape(*b.shape[:-2], K * (1 + rank), b.shape[-1]).float()
    if b.dim() == 2:
        out = matmul_exact(a_aug, b_aug)
    else:  # one product per group: a group is one request's (kv head's) rows
        out = torch.stack([torch.matmul(a_aug[g], b_aug[g]) for g in range(a.shape[0])])
    return out * sa * sb


def _broadcast_groups(a: torch.Tensor, b: torch.Tensor):
    """Broadcast A/B leading dims together and flatten them to one group
    axis: (..., M, K), (..., K, N) -> (G, M, K), (G, K, N), lead-shape."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:])
    g = math.prod(lead) if lead else 1
    return a3.reshape(g, *a.shape[-2:]), b3.reshape(g, *b.shape[-2:]), lead


def _reduce_to_shape(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum a gradient down to ``shape`` (undo the matmul's broadcast)."""
    if g.shape == shape:
        return g
    extra = g.dim() - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    keep = tuple(i for i, (gd, sd) in enumerate(zip(g.shape, shape)) if gd != sd)
    return g.sum(dim=keep, keepdim=True) if keep else g


def _lowrank_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor):
    """The straight-through surrogate: the full-precision matmul's
    gradients, in g's dtype, summed back to each operand's shape and cast
    to its dtype (JAX ``_lowrank_bwd``)."""
    ga = torch.matmul(g, b.transpose(-1, -2).to(g.dtype))
    if b.dim() > 2:
        gb = torch.matmul(a.transpose(-1, -2).to(g.dtype), g)
    else:
        gb = torch.matmul(a.reshape(-1, a.shape[-1]).T.to(g.dtype), g.reshape(-1, g.shape[-1]))
    return (_reduce_to_shape(ga, a.shape).to(a.dtype),
            _reduce_to_shape(gb, b.shape).to(b.dtype))


class _StraightThrough(torch.autograd.Function):
    """``fwd(a, b)`` forward on the detached operands, ``_lowrank_bwd`` backward."""

    @staticmethod
    def forward(ctx, a, b, fwd):
        ctx.save_for_backward(a, b)
        return fwd(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = _lowrank_bwd(a, b, g)
        return ga, gb, None


def _straight_through(fwd, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fwd(a, b)``, with the straight-through backward where grad is wanted."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _StraightThrough.apply(a, b, fwd)
    return fwd(a, b)


def _lowrank_any(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    if b.dim() == 2:
        return _lowrank_fwd(a, b, border, rank)
    a3, b3, lead = _broadcast_groups(a, b)
    return _lowrank_fwd(a3, b3, border, rank).reshape(*lead, a.shape[-2], b.shape[-1])


def matmul_amr_lowrank(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    """The low-rank form on plain PyTorch ops (JAX ``matmul_amr_lowrank``):
    A @ B + U[A] . V[B] as one float32 product over an augmented K; a 2-D B
    one product per request, a batched B one per group.  Backward: the
    straight-through surrogate."""
    return _straight_through(partial(_lowrank_any, border=border, rank=rank), a, b)


def _kernel_fwd(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
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


def matmul_amr_kernel(a: torch.Tensor, b: torch.Tensor, border: int, rank: int) -> torch.Tensor:
    """Kernel-backed AMR matmul (the serving and training hot path).

    A 2-D weight takes ``amr_matmul``: the full-LUT kernel at rank 0, the
    low-rank kernel otherwise.  A batched B (activation x activation) takes
    the grouped full-LUT kernel at rank 0 and the augmented-K matmul of
    ``_lowrank_fwd`` at rank > 0, the split the JAX package makes.
    Backward: the straight-through surrogate.
    """
    return _straight_through(partial(_kernel_fwd, border=border, rank=rank), a, b)


def _inject_fwd(a: torch.Tensor, b: torch.Tensor, numerics: AMRNumerics) -> torch.Tensor:
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


def matmul_amr_inject(a: torch.Tensor, b: torch.Tensor, numerics: AMRNumerics) -> torch.Tensor:
    """Exact per-product AMR error for any schedule.

    Quantizes both operands as the straight-through form does, replays the
    schedule's reduction circuit for every operand pair (the
    ``inject_replay`` kernel for CUDA tensors, its plain version for CPU
    tensors) and rescales, ``acc.float() * sa * sb``.  A 2-D B takes the
    replay matmul, a batched B (activation x activation) its grouped form.
    Bit-identical to ``matmul_amr_lut`` on the same schedule's table for
    inputs whose two quantizers agree (float32).  Backward: the
    straight-through surrogate.
    """
    return _straight_through(partial(_inject_fwd, numerics=numerics), a, b)


# product tables of registered schedules, keyed by (handle, device): the
# schedule they were built from, the table, its max|product|
_ORACLE_TABLES: dict[tuple, tuple] = {}


def _inject_oracle(a: torch.Tensor, b: torch.Tensor, numerics: AMRNumerics) -> torch.Tensor:
    """The plain table gather of the amr_inject products (the audit oracle).

    Gathers from a table built independently of the circuit replay:
    ``core/lut``'s for the paper's schedule at ``border``, or
    ``core/dse/export.lut_from_schedule`` (the numpy ``evaluate_split``
    over the 2^16 operand pairs) for a registered schedule
    (``numerics.schedule_ref``), so a zero audit difference shows the
    replay equal to the tabulated multiplier, not merely to itself.
    Quantizes with the inject path's front end, ``quantize_int8_ste``.
    """
    if numerics.schedule_ref is None:
        table = lut_lib.table_tensor(numerics.border, a.device)
        max_abs = lut_lib.table_max_abs(numerics.border)
        what = f"amr_inject(border={numerics.border}) oracle"
    else:
        table, max_abs = _oracle_table(numerics, a.device)
        what = f"amr_inject[{numerics.schedule_ref}] oracle"
    return _lut_matmul(a, b, table, max_abs, what, quantizer=quantize_int8_ste)


def _oracle_table(numerics: AMRNumerics, device: torch.device) -> tuple[torch.Tensor, int]:
    """The registered schedule's product table on ``device`` and its
    max|product|, rebuilt when the handle names another schedule."""
    from repro_torch.core.dse.export import lut_from_schedule  # lazy: import cycle

    from . import injection

    schedule = injection.resolve_schedule(numerics)
    key = (numerics.schedule_ref, torch.device(device))
    cached = _ORACLE_TABLES.get(key)
    if cached is None or cached[0] is not schedule:
        tab = lut_from_schedule(schedule)
        cached = (schedule, torch.from_numpy(tab).to(device), int(abs(tab).max()))
        _ORACLE_TABLES[key] = cached
    return cached[1], cached[2]


@lru_cache(maxsize=64)
def _noise_constants(border: int) -> tuple[float, float]:
    s = lut_lib.error_stats(border)
    return s["mean"], s["std"]


def _normal_draw(key: int, shape: tuple, device: torch.device) -> torch.Tensor:
    """The one place ``amr_noise`` draws: standard normals of ``shape`` in
    float32 from a ``torch.Generator`` on ``device`` seeded with ``key``
    (drawn flat, so a (rows, N) draw is the same numbers whatever the
    leading shape)."""
    gen = torch.Generator(device=device).manual_seed(key)
    return torch.randn(math.prod(shape), generator=gen, dtype=torch.float32,
                       device=device).reshape(shape)


def _key_batch(key) -> int | None:
    """The number of keys of a per-request key batch (a tuple or list, one
    key per request: ``noise_key`` under a (B,) step), or None for one key."""
    return len(key) if isinstance(key, (tuple, list)) else None


def matmul_amr_noise(a: torch.Tensor, b: torch.Tensor, border: int, key, *,
                     draw=_normal_draw) -> torch.Tensor:
    """Surrogate: exact matmul + error noise with AMR-MUL-matched moments.

    Per-element product error has mean mu and std sigma (from the table);
    a K-length accumulation contributes N(K*mu, sqrt(K)*sigma) in the int8
    domain, rescaled by the quantization scales.  The exact product of the
    int8-grid operands runs one product per request on a 2-D B
    (``matmul_exact``): its float32 sums pass 2**24 at K = 2048, where the
    order of a sum shows.

    ``key`` may be a batch of keys, one per request (the leading-axis rows
    divide evenly among them); each request's rows then come from its own
    stream, at the shape a solo call draws.  ``draw(key, shape, device)``
    makes the standard normals (``_normal_draw``; a test feeds JAX's).
    """
    mu, sigma = _noise_constants(border)
    qa, sa = quantize_int8_ste(a, axis=-1)
    qb, sb = quantize_int8_ste(b, axis=-2)
    k = a.shape[-1]
    exact = matmul_exact(qa, qb)
    nb = _key_batch(key)
    if nb is None:
        normal = draw(key, tuple(exact.shape), exact.device)
    else:
        rows = math.prod(exact.shape[:-1])
        if rows % nb:
            raise ValueError(
                f"amr_noise got {nb} per-request keys but {rows} output rows "
                f"({tuple(exact.shape)}); rows must divide evenly across requests")
        per = rows // nb
        normal = torch.cat([draw(kk, (per, exact.shape[-1]), exact.device) for kk in key])
        normal = normal.reshape(exact.shape)
    noise = mu * k + math.sqrt(float(k)) * sigma * normal
    return (exact + noise) * sa * sb


def resolve_numerics(numerics, site: str | None = None):
    """Resolve a policy (``numerics/policy.py``) at the ambient static
    layer; a bare ``AMRNumerics`` or None passes through.  The one
    resolution point of the model's sites and of ``approx_matmul``."""
    if numerics is None or isinstance(numerics, AMRNumerics):
        return numerics
    return numerics.resolve(site, current_scope().static_layer)


def approx_matmul(a: torch.Tensor, b: torch.Tensor, numerics=None, *, key=None,
                  site: str | None = None) -> torch.Tensor:
    """Dispatch a matmul under the given numerics policy (None = exact).

    ``numerics`` is one ``AMRNumerics`` or a site-resolved policy
    (``numerics/policy.py``), which resolves here against the call-site
    label ``site`` (e.g. ``"attn.qk"``) and the ambient scope's static
    layer.  ``site`` with the ambient scope's step, layer and unit also
    picks the ``amr_noise`` stream; an explicit ``key`` (one key or a
    per-request batch, ``context.noise_key``) overrides that derivation.

    Under ``numerics_scope(audit=AuditTrace())`` a reference is computed
    beside the impl and the site's difference recorded (per site, and per
    (site, layer) where the scope has a layer): ``compare="oracle"`` against
    the mode's bit-exact ``oracle`` in product-grid steps,
    ``compare="exact"`` against the exact float matmul, with its error mass.
    """
    scope = current_scope()
    numerics = resolve_numerics(numerics, site)
    if numerics is None or numerics.is_exact():
        return matmul_exact(a, b)
    spec = registry.get_mode(numerics.mode)
    out = spec.impl(a, b, numerics, key=key, site=site)
    if scope.audit is not None:
        _audit(scope, spec, out, a, b, numerics, site)
    return out


def _audit(scope, spec, out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, numerics,
           site: str | None) -> None:
    """Record one call site's difference to its reference in ``scope.audit``
    (read to the host here: the audit's one sync a call)."""
    audit = scope.audit
    with torch.no_grad():
        out = out.detach()
        if audit.compare == "exact":
            err = (out.float() - matmul_exact(a.detach(), b.detach()).float()).abs()
            diff, mass = err.max(), err.sum()
        elif spec.oracle is not None:
            diff = _grid_diff(out, spec.oracle(a.detach(), b.detach(), numerics), a, b)
            mass = diff
        else:
            return
    layer = _value(scope.layer)
    audit.record(site or "<unlabeled>", float(diff), layer=layer, mass=float(mass))


def _grid_diff(out: torch.Tensor, ref: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Max |out - ref| in integer-product-grid steps (the audit metric).

    Impl and oracle are both ``float(acc) * sa * sb`` on the same scales,
    so dividing the scales back out and rounding leaves 0 for float noise
    in the rescale and >= 1 for a real product mismatch (exact while |acc|
    < 2**24: the small shapes the matrix audits).
    """
    quantum = quantize_int8(a.detach(), axis=-1)[1] * quantize_int8(b.detach(), axis=-2)[1]
    return (torch.round(out / quantum) - torch.round(ref / quantum)).abs().max()


# --------------------------------------------------------------------------
# mode registration, in the JAX package's canonical order
# --------------------------------------------------------------------------

def _require_border(nm) -> None:
    if not isinstance(nm.border, int) or nm.border < 0:
        raise ValueError(f"numerics mode {nm.mode!r} needs a non-negative integer "
                         f"border, got {nm.border!r}")


def _validate_rank(nm, *, minimum: int) -> None:
    _require_border(nm)
    if not isinstance(nm.rank, int) or nm.rank < minimum:
        raise ValueError(f"numerics mode {nm.mode!r} needs an integer rank >= {minimum}, "
                         f"got {nm.rank!r}")


def _validate_inject(nm) -> None:
    _require_border(nm)
    if nm.schedule_ref is not None and not isinstance(nm.schedule_ref, str):
        raise ValueError(f"schedule_ref must be a registered-schedule handle (str) or "
                         f"None, got {nm.schedule_ref!r}")


registry.register_mode(
    "exact", lambda a, b, nm, *, key=None, site=None: matmul_exact(a, b),
    description="torch.matmul in the requested dtype (baseline)", exact=True)

registry.register_mode(
    "amr_lut", lambda a, b, nm, *, key=None, site=None: matmul_amr_lut(a, b, nm.border),
    required_params=("border",), validate=_require_border,
    description="bit-exact LUT-gather oracle (small shapes)")

registry.register_mode(
    "amr_inject", lambda a, b, nm, *, key=None, site=None: matmul_amr_inject(a, b, nm),
    required_params=("border",), validate=_validate_inject, oracle=_inject_oracle,
    accepts_params=("schedule_ref",),
    description="exact error injection by circuit replay (any schedule)")

registry.register_mode(
    "amr_lowrank",
    lambda a, b, nm, *, key=None, site=None: matmul_amr_lowrank(a, b, nm.border, nm.rank),
    required_params=("border", "rank"), validate=partial(_validate_rank, minimum=1),
    defaults={"rank": 4}, description="low-rank error factorization, one float32 product")

registry.register_mode(
    "amr_noise", lambda a, b, nm, *, key=None, site=None: matmul_amr_noise(
        a, b, nm.border, key if key is not None else noise_key(nm.noise_seed, site)),
    required_params=("border", "noise_seed"), validate=_require_border,
    description="Gaussian surrogate with AMR-matched moments")

registry.register_mode(
    "amr_kernel",
    lambda a, b, nm, *, key=None, site=None: matmul_amr_kernel(a, b, nm.border, nm.rank),
    required_params=("border", "rank"), validate=partial(_validate_rank, minimum=0),
    defaults={"rank": 0}, description="hand-written CUDA kernels (rank 0 = full-LUT gather)")
