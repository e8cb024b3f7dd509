"""Plain PyTorch version of the SSD chunked scan.

The port of the JAX package's ``models/ssm.py::ssd_chunked`` (which its
``kernels/ssd_scan/ref.py`` re-exports), step for step: right-pad to a chunk
multiple with ``dt = 0``, the intra-chunk dual quadratic form masked before
``exp``, the chunk states, and the inter-chunk recurrence as a loop over
chunks.  The kernel wrapper (``kernel.py``) runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel against it on the card; autograd
through it (``ssd_ref_grads``) is the plain backward, likewise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def chunk_cumsum(dt: torch.Tensor, a_log: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cumulative log decay within each chunk: dt (B, S, H) -> (B, nc, Q, H),
    ``cumsum(-exp(a_log) * dt)`` over a chunk, dt padded with zeros to a
    chunk multiple (padding leaves the state unchanged)."""
    B, S, H = dt.shape
    pad = -S % chunk
    dt = F.pad(dt.float(), (0, 0, 0, pad))
    la = -torch.exp(a_log.float()) * dt
    return torch.cumsum(la.reshape(B, -1, chunk, H), dim=2)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int, *, split: bool = False, join: bool = True) -> tuple:
    """x (B, S, H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N) grouped.

    ``split=False`` returns (y (B, S, H, P), h_final (B, H, N, P)), y with
    the inter-chunk readout ``exp(cum) * (C @ h_prev)``; ``split=True``
    returns (y_intra, h_prev (B, nc, H, N, P), h_final): y without that
    readout, and the state before each chunk, for the caller to read out
    through the numerics seam.  Everything is float32.  ``join=False``
    computes the same values but cuts the gradient that the state update
    ``h_{c+1} = exp(cum_Q) h_c + S_c`` carries back into h_c (the backward's
    reverse join): only ``ssd_carried_grads`` asks for that.
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    pad = -S % chunk
    x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    b = F.pad(b.float(), (0, 0, 0, 0, 0, pad))
    c = F.pad(c.float(), (0, 0, 0, 0, 0, pad))
    dtp = F.pad(dt.float(), (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    rep = H // G

    cum = chunk_cumsum(dt, a_log, chunk)                          # (B, nc, Q, H)
    xc = (x * dtp[..., None]).reshape(B, nc, chunk, H, P)
    bh = b.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)  # (B, nc, Q, H, N)
    ch = c.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    # intra-chunk dual form; mask BEFORE exp: the upper triangle holds
    # positive log-decays that overflow
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B, nc, Q, Q, H) t, s
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -1e30))
    cb = torch.einsum("bnthi,bnshi->bntsh", ch, bh)
    y = torch.einsum("bntsh,bnshp->bnthp", cb * decay, xc)

    # chunk states and the inter-chunk recurrence h_c = exp(sum la_c) h_{c-1} + S_c
    tail = torch.exp(cum[:, :, -1:, :] - cum)                   # (B, nc, Q, H)
    states = torch.einsum("bnshi,bnshp->bnhip", bh * tail[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B, nc, H)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(h)
        h = chunk_decay[:, i, :, None, None] * (h if join else h.detach()) + states[:, i]
    h_prev = torch.stack(prev, dim=1)                           # (B, nc, H, N, P)

    if not split:
        y = y + torch.einsum("bnthi,bnhip->bnthp", ch * torch.exp(cum)[..., None], h_prev)
    y = y.reshape(B, nc * chunk, H, P)[:, :S]
    return (y, h_prev, h) if split else (y, h)


def ssd_ref_grads(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int, grads: tuple, *, split: bool = False,
                  join: bool = True) -> tuple:
    """The plain backward: (dx, ddt, da_log, db, dc) by torch autograd
    through ``ssd_ref``, given the gradients of its outputs (``grads``, in
    its output order), each in its input's dtype (db and dc summed over the
    heads of a group in float32 before the cast, as ``repeat_interleave``'s
    backward sums them).  ``join`` as in ``ssd_ref``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, a_log, b, c)]
        # the state before the first chunk is a constant 0: no gradient flows from it
        pairs = [(o, g) for o, g in zip(ssd_ref(*ins, chunk, split=split, join=join), grads)
                 if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs],
                                  allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(ins, got))


def ssd_error_bound(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int, *, split: bool = False) -> tuple:
    """Per-output bounds on the gap between two float32 implementations of
    ``ssd_ref`` that sum in different orders: ``tau * T``, where T is the
    same function of |x|, |b|, |c| (every term taken positive: dt >= 0 and
    the decays are positive) and, per (batch, chunk i, head),

        tau = 2**-23 * (min(n, 8 sqrt(n)) + 16 (1 + max |cum|)),

    the max over that head's rows in chunks 0..i.  n = 2 N + Q + i + 1
    counts the roundings along the longest chain of sums (the C B^T and
    C h dots over N, the row sum over Q, one state update per chunk); a
    sum of n terms is off by at most n u sum |terms|, and, its roundings
    independent, by more than 8 sqrt(n) u sum |terms| with probability
    below 2 n exp(-32), about 1e-11 (Higham and Mary, "A new approach to
    probabilistic rounding error analysis", 2019; u = 2**-24, each of the
    two sides).  The last term is the rounding of the cumulative log
    decay, whose absolute error, about 8 ulps of max |cum| on each side, is
    the relative error of a decay factor exp(cum_t - cum_s).  The state
    before chunk i carries the decays of every earlier chunk, hence the max
    over chunks 0..i.  A row's outputs take their chunk's tau, the state
    before chunk i takes chunk i's, the final state the last chunk's.
    Returns one bound per output of ``ssd_ref``.
    """
    terms = ssd_ref(x.abs(), dt, a_log, b.abs(), c.abs(), chunk, split=split)
    S, N = x.shape[1], b.shape[-1]
    cum_max = chunk_cumsum(dt, a_log, chunk).abs().amax(dim=2).cummax(dim=1).values  # (B, nc, H)
    chain = torch.arange(1, cum_max.shape[1] + 1, device=cum_max.device)[None, :, None]
    n = (2 * N + chunk + chain).float()
    tau = 2.0 ** -23 * (torch.minimum(n, 8 * torch.sqrt(n)) + 16 * (1 + cum_max))
    row_tau = tau.repeat_interleave(chunk, dim=1)[:, :S, :, None]          # (B, S, H, 1)
    state_tau = tau[..., None, None]                                        # (B, nc, H, 1, 1)
    taus = (row_tau, state_tau, state_tau[:, -1]) if split else (row_tau, state_tau[:, -1])
    return tuple(t * term + 1e-30 for t, term in zip(taus, terms))


def ssd_carried(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, *, split: bool = False) -> tuple:
    """The part of each output of ``ssd_ref`` that the state carried across
    chunk boundaries contributes, in the same tuple: in full mode the
    readout ``exp(cum) (C @ h_prev)`` of y; in split mode none of y; the
    decayed earlier state ``exp(cum_Q) h`` in the state before each chunk
    and in the final state.  A kernel that dropped the carry would be off
    by exactly this, so a check can see the carry only where it exceeds
    ``ssd_error_bound``.
    """
    y_intra, h_prev, _ = ssd_ref(x, dt, a_log, b, c, chunk, split=True)
    decay = torch.exp(chunk_cumsum(dt, a_log, chunk)[:, :, -1, :])[..., None, None]
    carried = decay * h_prev  # (B, nc, H, N, P): the carried part of the state after chunk i
    if split:
        before = torch.cat([torch.zeros_like(carried[:, :1]), carried[:, :-1]], dim=1)
        return torch.zeros_like(y_intra), before, carried[:, -1]
    y, _ = ssd_ref(x, dt, a_log, b, c, chunk)
    return y - y_intra, carried[:, -1]


def ssd_carried_grads(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, chunk: int, grads: tuple, *, split: bool = False) -> tuple:
    """The part of each gradient of ``ssd_ref_grads`` that the reverse join
    carries back across chunk boundaries (the state gradient of a later
    chunk, decayed into an earlier one): the full gradient less the one with
    the join cut.  A backward kernel that dropped or mis-scaled the join
    would be off by about this much, so a check sees the join only where it
    exceeds the check's tolerance (dc has none: C reads the forward's state,
    not the state gradient)."""
    full = ssd_ref_grads(x, dt, a_log, b, c, chunk, grads, split=split)
    cut = ssd_ref_grads(x, dt, a_log, b, c, chunk, grads, split=split, join=False)
    return tuple(f.float() - k.float() for f, k in zip(full, cut))


GRAD_RTOL = 1e-4  # of each gradient's largest |value|: float32 sums in other orders


def ssd_grad_rtol(dt: torch.Tensor, a_log: torch.Tensor, chunk: int) -> float:
    """The relative tolerance of a backward's gradients against the plain
    ones: GRAD_RTOL plus 2**-23 * 16 * (1 + max |cum|), the relative error
    of a decay factor exp(cum_t - cum_s) when the two sides round the
    cumulative log decay in other orders (about 8 ulps of max |cum| each,
    as in ``ssd_error_bound``).  With the model's dt, |cum| reaches about
    3300 within a chunk and this term 6e-3; where a chunk decays the state
    by exp(-0.5) it is 2e-6."""
    cum_max = float(chunk_cumsum(dt, a_log, chunk).abs().max())
    return GRAD_RTOL + 2.0 ** -23 * 16 * (1 + cum_max)


def ssd_grad_excess(got: torch.Tensor, want: torch.Tensor, rtol: float = GRAD_RTOL) -> float:
    """How far a backward's gradient is from the plain one, over its
    tolerance: max |got - want| / (rtol max |want| + step), where step is
    one bf16 rounding step of |want| (2**-7 |want|) for a bf16 gradient
    (either side may round a value near a tie the other way) and 0 for a
    float32 one.  At most 1 passes."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    step = 2.0 ** -7 * want.abs() if bf16 else 0.0
    tol = rtol * float(want.abs().max()) + step + 1e-30
    return float(((got - want).abs() / tol).max())
