"""Mamba2 (SSD, state-space duality) mixer: chunked prefill and O(1) decode.

The port of the JAX package's ``models/ssm.py``.  A sequence is split into
chunks; within a chunk the dual quadratic form runs, across chunks a small
(H, N, P) state recurrence carries.  In every prefill the chunked scan runs
in the hand-written CUDA kernel of ``kernels/ssd_scan`` (its plain version
for CPU tensors).  Decode keeps a conv ring and the SSM state, one
elementwise recurrence step per token.

Projections are separate parameters (``wz/wx/wb/wc/wdt`` and one depthwise
conv per segment), as in the JAX package.  Every projection goes through
the numerics policy (sites ``ssm.wz`` ... ``ssm.out_proj``), and so does the
readout of the carried state, ``C . h`` (site ``ssm.scan``); the
intra-chunk form and the recurrence stay exact.  Under an approximate
policy the scan kernel runs in split mode and the readout goes through the
seam, as the JAX package's ``ssd_chunked`` splits it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ops import decay_weighted_c
from repro_torch.numerics import approx_matmul, resolve_numerics
from repro_torch.numerics.approx_matmul import per_request

from .layers import dense, rms_norm


def ssm_dims(d_model: int, cfg: SSMConfig) -> dict:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return dict(d_inner=d_inner, n_heads=n_heads, d_bc=cfg.n_groups * cfg.d_state)


def _a_log_init(shape, device) -> torch.Tensor:
    """log(linspace(1, 16, H)) along the last axis, the JAX package's init."""
    h = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device)
    return torch.log(h).expand(shape).clone()


def _ones_init(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def ssm_param_specs(d_model: int, cfg: SSMConfig, dtype: torch.dtype, stacked) -> dict:
    """The mixer's parameters as (shape, dtype, init) leaves, in the JAX
    package's layout; ``init`` is a normal std, None for zeros, or a
    function of (shape, device).  ``stacked(*shape)`` adds the group axis."""
    dims = ssm_dims(d_model, cfg)
    d_inner, d_bc, H = dims["d_inner"], dims["d_bc"], dims["n_heads"]
    W, f32 = cfg.conv_width, torch.float32
    s = d_model ** -0.5
    return {
        "wz": (stacked(d_model, d_inner), dtype, s),
        "wx": (stacked(d_model, d_inner), dtype, s),
        "wb": (stacked(d_model, d_bc), dtype, s),
        "wc": (stacked(d_model, d_bc), dtype, s),
        "wdt": (stacked(d_model, H), dtype, s),
        "conv_x": (stacked(W, d_inner), dtype, 0.1),
        "conv_b": (stacked(W, d_bc), dtype, 0.1),
        "conv_c": (stacked(W, d_bc), dtype, 0.1),
        "conv_bias_x": (stacked(d_inner), dtype, None),
        "conv_bias_b": (stacked(d_bc), dtype, None),
        "conv_bias_c": (stacked(d_bc), dtype, None),
        "a_log": (stacked(H), f32, _a_log_init),
        "dt_bias": (stacked(H), f32, None),
        "d_skip": (stacked(H), f32, _ones_init),
        "norm": (stacked(d_inner), f32, None),
        "out_proj": (stacked(d_inner, d_model), dtype, d_inner ** -0.5),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # jax.nn.silu's form


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, i.e. logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|)),
    with no threshold (unlike F.softplus)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _window_sum(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i window[:, i] * w[i] over the conv width, the products rounded in
    the working dtype and summed in float32 in order i = 0.. (jnp.sum's
    upcast), then cast back.  Elementwise only, so each row is its own."""
    acc = (window[:, 0] * w[0]).float()
    for i in range(1, w.shape[0]):
        acc = acc + (window[:, i] * w[i]).float()
    return acc.to(window.dtype)


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W: xs (B, S, C), w (W, C).

    A sum of W shifted products in the working dtype, in order (the JAX
    package's form), not ``F.conv1d``, which cuDNN may run in TF32 and sums
    in another order.
    """
    W, S = w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i]
    return _silu(out + b)


def ssd_chunked(x, dt, a_log, b, c, chunk: int, return_state: bool = False,
                numerics=None):
    """SSD scan. x (B, S, H, P), dt (B, S, H), b/c (B, S, G, N) -> y (B, S, H, P)
    float32 (and the final (B, H, N, P) state with ``return_state``).

    Exact numerics: the kernel gives the whole y.  Otherwise the kernel
    gives the intra-chunk y and the state before each chunk, and the
    readout ``(C exp(cum)) @ h_prev`` runs through the seam at ``ssm.scan``
    as one (B, nc, H, Q, N) @ (B, nc, H, N, P) grouped product.  A policy
    resolves at site ``ssm.scan``.
    """
    numerics = resolve_numerics(numerics, "ssm.scan")
    if numerics is None or numerics.is_exact():
        y, h_final = ssd_scan(x, dt, a_log, b, c, chunk)
    else:
        B, S, H, P = x.shape
        if c.requires_grad:
            # c feeds the scan and the readout panel: widened once, as the JAX
            # package's ch is, its two gradients meet in float32 before one
            # cast to c's dtype (x and b follow: the scan takes one dtype)
            x, b, c = x.float(), b.float(), c.float()
        y_intra, h_prev, h_final = ssd_scan(x, dt, a_log, b, c, chunk, split=True)
        dc = decay_weighted_c(dt, a_log, c, chunk, H)
        y_inter = approx_matmul(dc, h_prev, numerics, site="ssm.scan")
        y = y_intra + y_inter.permute(0, 1, 3, 2, 4).reshape(B, -1, H, P)[:, :S]
    return (y, h_final) if return_state else y


def _mix(params: dict, xin, d_model: int, cfg: SSMConfig, numerics, eps: float,
         return_state: bool):
    """The full-sequence mixer; also the decode state with ``return_state``."""
    dims = ssm_dims(d_model, cfg)
    d_inner, H = dims["d_inner"], dims["n_heads"]
    z = dense(xin, params["wz"], numerics, site="ssm.wz")
    x_raw = dense(xin, params["wx"], numerics, site="ssm.wx")
    b_raw = dense(xin, params["wb"], numerics, site="ssm.wb")
    c_raw = dense(xin, params["wc"], numerics, site="ssm.wc")
    dt = dense(xin, params["wdt"], numerics, site="ssm.wdt")

    x = _causal_conv(x_raw, params["conv_x"], params["conv_bias_x"])
    b = _causal_conv(b_raw, params["conv_b"], params["conv_bias_b"])
    c = _causal_conv(c_raw, params["conv_c"], params["conv_bias_c"])

    B_, S, _ = x.shape
    x = x.reshape(B_, S, H, cfg.head_dim)
    b = b.reshape(B_, S, cfg.n_groups, cfg.d_state)
    c = c.reshape(B_, S, cfg.n_groups, cfg.d_state)
    dt = _softplus(dt.float() + params["dt_bias"])
    y, h_final = ssd_chunked(x, dt, params["a_log"], b, c, cfg.chunk, return_state=True,
                             numerics=numerics)
    y = y + params["d_skip"][None, None, :, None] * x.float()
    y = y.reshape(B_, S, d_inner).to(xin.dtype)
    y = y * _silu(z)
    y = rms_norm(y, params["norm"], eps)
    out = dense(y, params["out_proj"], numerics, site="ssm.out_proj")
    if not return_state:
        return out
    W = cfg.conv_width

    def tail(t):  # last W-1 raw inputs, zero-padded for short sequences
        return F.pad(t[:, -(W - 1):, :], (0, 0, max(W - 1 - t.shape[1], 0), 0))

    return out, SSMState(tail(x_raw), tail(b_raw), tail(c_raw), h_final)


def ssm_forward(params: dict, xin: torch.Tensor, d_model: int, cfg: SSMConfig,
                numerics=None, eps: float = 1e-6) -> torch.Tensor:
    """Full-sequence Mamba2 mixer (train / prefill)."""
    return _mix(params, xin, d_model, cfg, numerics, eps, return_state=False)


def ssm_prefill(params: dict, xin: torch.Tensor, d_model: int, cfg: SSMConfig,
                numerics=None, eps: float = 1e-6):
    """Full-sequence forward that also returns the decode state (prefill ->
    decode handoff): the final SSM state and the conv rings' raw tails."""
    return _mix(params, xin, d_model, cfg, numerics, eps, return_state=True)


# ------------------------------------------------------------------ decode
@dataclasses.dataclass
class SSMState:
    conv_x: torch.Tensor  # (B, W-1, d_inner) ring of recent x projections
    conv_b: torch.Tensor  # (B, W-1, d_bc)
    conv_c: torch.Tensor  # (B, W-1, d_bc)
    h: torch.Tensor       # (B, H, N, P) SSM state, float32

    @classmethod
    def zeros(cls, batch, d_model, cfg: SSMConfig, dtype, device):
        dims = ssm_dims(d_model, cfg)
        W = cfg.conv_width - 1
        return cls(
            torch.zeros((batch, W, dims["d_inner"]), dtype=dtype, device=device),
            torch.zeros((batch, W, dims["d_bc"]), dtype=dtype, device=device),
            torch.zeros((batch, W, dims["d_bc"]), dtype=dtype, device=device),
            torch.zeros((batch, dims["n_heads"], cfg.d_state, cfg.head_dim),
                        dtype=torch.float32, device=device),
        )


def _conv_step(ring, new, w, bias):
    window = torch.cat([ring, new[:, None, :]], dim=1)          # (B, W, C)
    return _silu(_window_sum(window, w) + bias), window[:, 1:, :]


def _per_row_on_cpu(fn, *ts):
    """``fn`` over the batch rows of ``ts``: at once on CUDA, one row at a
    time on the CPU (``per_request``).

    ATen's CPU loops run the vectorised form of a transcendental function
    (exp, log1p, sigmoid) on whole pairs of SIMD vectors and the scalar form
    on the tail, so on the CPU a narrow row's bits would depend on where it
    sits in the batch; a CUDA kernel computes every element alike.  Row by
    row, a request computes the same bits batched or alone.
    """
    return fn(*ts) if ts[0].device.type != "cpu" else per_request(fn, *ts)


def _readout_exact(ch: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sum_n ch[b, h, n] h[b, h, n, p], one (H, 1, N) @ (H, N, P) product per
    request (``per_request``)."""
    return per_request(lambda c, s: torch.matmul(c[0, :, None, :], s[0])[None, :, 0], ch, h)


def ssm_decode(params: dict, xin: torch.Tensor, state: SSMState, d_model: int,
               cfg: SSMConfig, numerics=None,
               eps: float = 1e-6) -> tuple[torch.Tensor, SSMState]:
    """One-token step. xin: (B, 1, d_model).  The projections take the
    (B, 1, d) rows, so an exact product runs one request per call."""
    dims = ssm_dims(d_model, cfg)
    d_inner, H = dims["d_inner"], dims["n_heads"]
    z = dense(xin, params["wz"], numerics, site="ssm.wz")[:, 0]
    x = dense(xin, params["wx"], numerics, site="ssm.wx")[:, 0]
    b = dense(xin, params["wb"], numerics, site="ssm.wb")[:, 0]
    c = dense(xin, params["wc"], numerics, site="ssm.wc")[:, 0]
    dt = dense(xin, params["wdt"], numerics, site="ssm.wdt")[:, 0]

    a = -torch.exp(params["a_log"].float())
    rep = H // cfg.n_groups

    def advance(x, b, c, dt, ring_x, ring_b, ring_c, h):
        x, ring_x = _conv_step(ring_x, x, params["conv_x"], params["conv_bias_x"])
        b, ring_b = _conv_step(ring_b, b, params["conv_b"], params["conv_bias_b"])
        c, ring_c = _conv_step(ring_c, c, params["conv_c"], params["conv_bias_c"])
        Bt = x.shape[0]
        x = x.reshape(Bt, H, cfg.head_dim).float()
        bh = b.reshape(Bt, cfg.n_groups, cfg.d_state).float().repeat_interleave(rep, dim=1)
        ch = c.reshape(Bt, cfg.n_groups, cfg.d_state).float().repeat_interleave(rep, dim=1)
        dt = _softplus(dt.float() + params["dt_bias"])          # (B, H)
        decay = torch.exp(a[None] * dt)                         # (B, H)
        xdt = x * dt[..., None]                                 # (B, H, P)
        h = decay[..., None, None] * h + bh[..., None] * xdt[:, :, None, :]
        return x, ch, h, ring_x, ring_b, ring_c

    x, ch, h_new, ring_x, ring_b, ring_c = _per_row_on_cpu(
        advance, x, b, c, dt, state.conv_x, state.conv_b, state.conv_c, state.h)
    nm = resolve_numerics(numerics, "ssm.scan")
    if nm is not None and not nm.is_exact():
        # one-row state readout through the seam: (B, H, 1, N) @ (B, H, N, P)
        yss = approx_matmul(ch[:, :, None, :], h_new, nm, site="ssm.scan")[:, :, 0, :]
    else:
        yss = _readout_exact(ch, h_new)

    def gate(yss, x, z):
        y = yss + params["d_skip"][None, :, None] * x
        y = y.reshape(y.shape[0], d_inner).to(xin.dtype)
        return (rms_norm(y * _silu(z), params["norm"], eps),)

    (y,) = _per_row_on_cpu(gate, yss, x, z)
    out = dense(y[:, None, :], params["out_proj"], numerics, site="ssm.out_proj")
    return out, SSMState(ring_x, ring_b, ring_c, h_new)
