"""LM assembly for the dense, SSM, hybrid, MoE, audio and VLM families:
init, forward, encode, prefill and decode.

The port of the JAX package's ``models/model.py``.  The parameter tree
keeps the JAX layout, so that both packages can compute on the same
weights (``convert.params_from_numpy``):

  {"embed": (V, D), "final_norm": (D,),
   "layers": ({"ln1", "ln2", "attn": {...}, "mlp": {...}},)}   # "full", "swa" layers
   "layers": ({"ln1", "ln2", "ssm": {...}},)                    # "ssm" layers
   "layers": ({"ln1", "ln2", "mlp": {...}},)                    # "shared_attn" layers
   "shared": {"attn": {...}, "ln1", "ln2", "mlp": {...}}}      # with "shared_attn" layers

With ``cfg.encoder_layers`` set (whisper), each attention layer also holds
``"xattn": {"wq", "wk", "wv", "wo"}`` and ``"ln_x"``, and the tree holds
the encoder, ``"encoder": {"ln1", "ln2", "attn", "mlp"}`` (leaves stacked
over the encoder's layers) and ``"enc_norm"``; a "cross" layer holds
``xattn`` and ``ln_x`` whatever the config.  With ``cfg.vision_prefix`` set
(a VLM) the tree holds ``"vision_proj"`` (D, D).

With ``cfg.moe`` set, an attention layer holds ``"moe": {"router", "w_gate",
"w_up", "w_down"}`` in place of ``"mlp"`` (``models/moe.py``), and
``forward`` returns the sum of the layers' load-balancing losses as its aux.

A "swa" layer is a "full" one that attends within ``cfg.sliding_window``
tokens; its decode cache is a ring of min(capacity, window) slots.  A
"shared_attn" layer (zamba2's) applies the one model-level ``shared``
attention + MLP block, a full-attention layer with its own KV cache at
each application; its per-layer entry is kept, unread, as in the JAX
package (``unread_params``).

``layers`` holds one dict per layer kind of a group, its leaves stacked
over the group's ``n_repeat`` copies.  Where the JAX package scans over the
stacked copies, this module loops in Python.  Decode caches mirror the same
grouping: one ``KVCache`` (attention) or ``SSMState`` (conv rings and
state, no position) per kind, leaves stacked over ``n_repeat``.  A Mamba2
block has no MLP: its ``ln2`` is kept, unread, as in the JAX package.

Every matmul of every layer runs under ``cfg.numerics``, an
``AMRNumerics`` or a site- and layer-resolved policy; the LM head and the
vision projection stay exact.  Each layer runs inside
``numerics_scope(layer=, static_layer=)`` with its flat index (group g,
kind i: g * len(kinds) + i), the coordinate a per-layer policy resolves
against; a layer's cross-attention K and V are computed inside its scope,
in the forward, in prefill and again at every decode step, as the JAX
package computes them.  Encoder layer g runs in ``numerics_scope(layer=-1 -
g)`` with no static layer: ``amr_noise`` draws other keys than the
decoder's, and a per-layer policy resolves through its site and default
entries.

**Extra embeddings** (``extra_embeddings``: the stub frontends' output).
A VLM's (B, P, D) patch embeddings go through the exact ``vision.proj``
dense and are prepended to the token embeddings, and ``forward`` drops
the P prefix positions from its logits (unless ``last_only``); a
decoder's KV cache must hold the prefix too.  An audio model's (B, T, D)
frames go through the bidirectional encoder (``encode``), whose output
every decoder layer cross-attends to; ``decode_step`` takes that output
as ``enc_out``.  Without extra embeddings the model runs decoder only, as
the JAX package's launchers run it, and the encoder, cross-attention and
vision leaves read nothing (``unread_params(cfg, with_extra=False)``).

``forward`` is also the training forward: it runs under autograd (no
in-place write to a tensor autograd saved), and with ``cfg.remat ==
"block"`` and grad enabled each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps each
layer in ``jax.checkpoint``: the backward recomputes the layer's forward,
its kernel launches included.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.numerics import current_scope, numerics_scope
from repro_torch.numerics.context import HostOnce

from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import dense, embed, mlp, rms_norm, unembed
from .tree import tree_items, tree_map

_KINDS = ("full", "swa", "ssm", "shared_attn", "cross")
# per-layer leaves no computation reads, by kind: a Mamba2 block has no MLP,
# and a shared-attention layer runs the model-level "shared" block
_UNREAD = {"ssm": ("ln2",), "shared_attn": ("ln1", "ln2", "mlp")}


def group_structure(cfg: ModelConfig) -> tuple[tuple[str, ...], int]:
    """(kinds within one group, n_repeat)."""
    if cfg.pattern is not None:
        kinds, n_repeat = cfg.pattern.kinds, cfg.pattern.n_repeat
    else:
        kinds, n_repeat = (cfg.default_mixer,), cfg.n_layers
    unported = [k for k in kinds if k not in _KINDS]
    if unported:
        raise NotImplementedError(
            f"layer kinds {unported} of {cfg.name} are not ported yet; the port runs "
            f"{_KINDS} layers")
    return kinds, n_repeat


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as (shape, dtype, init) leaves: ``init`` is a
    normal std, None for zeros, or a function of (shape, device)."""
    kinds, n_repeat = group_structure(cfg)
    D, F_ = cfg.d_model, cfg.d_ff
    HD, KD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    dt, f32 = _dtype(cfg), torch.float32

    def stacked(*shape):
        return (n_repeat, *shape)

    def single(*shape):
        return shape

    def attn_block(shape) -> dict:
        a = {
            "wq": (shape(D, HD), dt, D ** -0.5),
            "wk": (shape(D, KD), dt, D ** -0.5),
            "wv": (shape(D, KD), dt, D ** -0.5),
            "wo": (shape(HD, D), dt, HD ** -0.5),
        }
        if cfg.qk_norm:
            a["q_norm"] = (shape(cfg.head_dim), f32, None)
            a["k_norm"] = (shape(cfg.head_dim), f32, None)
        return a

    def mlp_block(shape) -> dict:
        return {
            "w_gate": (shape(D, F_), dt, D ** -0.5),
            "w_up": (shape(D, F_), dt, D ** -0.5),
            "w_down": (shape(F_, D), dt, F_ ** -0.5),
        }

    def norms(shape) -> dict:
        return {"ln1": (shape(D), f32, None), "ln2": (shape(D), f32, None)}

    def cross(kind: str) -> dict:
        if kind != "cross" and not cfg.encoder_layers:
            return {}
        return {"xattn": attn.cross_attention_specs(D, cfg.n_heads, cfg.head_dim, dt, stacked),
                "ln_x": (stacked(D), f32, None)}

    def ffn() -> dict:
        if cfg.moe is not None:
            return {"moe": moe_lib.moe_param_specs(D, cfg.moe, dt, stacked)}
        return {"mlp": mlp_block(stacked)}

    def layer(kind: str) -> dict:
        if kind == "ssm":
            return {**norms(stacked), "ssm": ssm_lib.ssm_param_specs(D, cfg.ssm, dt, stacked)}
        if kind == "shared_attn":
            return {**norms(stacked), "mlp": mlp_block(stacked)}
        return {**norms(stacked), "attn": attn_block(stacked), **cross(kind), **ffn()}

    specs = {
        "embed": ((cfg.vocab, D), dt, D ** -0.5),
        "final_norm": ((D,), f32, None),
        "layers": tuple(layer(k) for k in kinds),
    }
    if "shared_attn" in kinds:
        specs["shared"] = {"attn": attn_block(single), **norms(single), "mlp": mlp_block(single)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((cfg.vocab, D), dt, D ** -0.5)
    if cfg.encoder_layers:
        def enc(*shape):
            return (cfg.encoder_layers, *shape)
        specs["encoder"] = {**norms(enc), "attn": attn_block(enc), "mlp": mlp_block(enc)}
        specs["enc_norm"] = ((D,), f32, None)
    if cfg.vision_prefix:
        specs["vision_proj"] = ((D, D), dt, D ** -0.5)
    return specs


def unread_params(cfg: ModelConfig, with_extra: bool = True) -> frozenset[str]:
    """Paths (``tree_items`` form, ``layers/0/ln2``) of the parameter leaves
    that no computation reads: each "ssm" layer's ``ln2`` and each
    "shared_attn" layer's ``ln1``, ``ln2`` and ``mlp``; and, for a forward
    without extra embeddings (``with_extra=False``: decoder only), the
    encoder, ``enc_norm``, each layer's ``xattn`` and ``ln_x`` and
    ``vision_proj``.  ``jax.grad`` gives them zero gradients; the port's
    train step does the same."""
    kinds, _ = group_structure(cfg)
    roots = tuple(f"layers/{i}/{k}" for i, kind in enumerate(kinds) for k in _UNREAD.get(kind, ()))
    if not with_extra:
        roots += ("encoder", "enc_norm", "vision_proj")
        roots += tuple(f"layers/{i}/{k}" for i in range(len(kinds)) for k in ("xattn", "ln_x"))
    paths = [p for p, _ in tree_items(_map_specs(lambda *_: None, param_specs(cfg)))]
    return frozenset(p for p in paths if any(p == r or p.startswith(r + "/") for r in roots))


def _is_spec(node) -> bool:
    return isinstance(node, tuple) and len(node) == 3 and isinstance(node[1], torch.dtype)


def _map_specs(fn, node):
    if _is_spec(node):
        return fn(*node)
    if isinstance(node, dict):
        return {k: _map_specs(fn, v) for k, v in node.items()}
    return tuple(_map_specs(fn, v) for v in node)


_DRAW_BYTES = 1 << 32  # a leaf whose float32 draw is larger is drawn a slice at a time


def init_params(cfg: ModelConfig, seed: int = 0, *, device: str | torch.device = "cuda") -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``.

    Normal(0, std) per weight, drawn in float32 and cast to ``cfg.dtype``;
    norm scales start at zero; the SSM's ``a_log`` and ``d_skip`` take the
    JAX package's fixed values.  A leaf whose float32 draw passes 4 GiB
    (moonshot-v1-16b-a3b's stacked experts: 35.4 GB each) is drawn one
    leading slice at a time into its ``cfg.dtype`` tensor, so the float32
    copy never exists whole.  The numbers differ from the JAX package's
    (another generator); ``convert.params_from_numpy`` carries the JAX
    package's weights over where both must compute on the same ones.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std, dtype):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(std).to(dtype)

    def draw(shape, dtype, std):
        if std is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if callable(std):
            return std(shape, dev).to(dtype)
        if 4 * math.prod(shape) <= _DRAW_BYTES:
            return normal(shape, std, dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], std, dtype)
        return out

    return _map_specs(draw, param_specs(cfg))


def _layer(params: dict, g: int) -> dict:
    return tree_map(lambda t: t[g], params)


def _block_params(params: dict, kind: str, i: int, g: int) -> dict:
    """The parameters layer (g, i) computes with: the model-level shared
    block for a "shared_attn" layer, else its own copy."""
    return params["shared"] if kind == "shared_attn" else _layer(params["layers"][i], g)


def _attn_kwargs(cfg: ModelConfig, kind: str) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                window=cfg.sliding_window if kind == "swa" else 0,
                numerics=cfg.numerics, eps=cfg.norm_eps)


def _kv_capacity(cfg: ModelConfig, kind: str, capacity: int) -> int:
    """A sliding-window layer's ring holds at most its window."""
    if kind == "swa" and cfg.sliding_window:
        return min(capacity, cfg.sliding_window)
    return capacity


def _head(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's MLP, or its MoE layer where ``cfg.moe`` is set: (output,
    aux loss, None for an MLP)."""
    if "moe" in lp:
        return moe_lib.moe_forward(lp["moe"], h, cfg.moe, numerics=cfg.numerics)
    return mlp(lp["mlp"], h, cfg.mlp_act, cfg.numerics), None


def _cross(cfg: ModelConfig, lp: dict, x: torch.Tensor, enc_out) -> torch.Tensor:
    """The layer's cross-attention block where it has one and an encoder
    output is given: its K and V over ``enc_out``, then x + attention of
    ``ln_x``(x) to them; else x."""
    if enc_out is None or "xattn" not in lp:
        return x
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, numerics=cfg.numerics)
    enc_kv = attn.encode_cross_kv(lp["xattn"], enc_out, **kw)
    return x + attn.attend_cross(lp["xattn"], rms_norm(x, lp["ln_x"], cfg.norm_eps), enc_kv, **kw)


def _layer_full(cfg: ModelConfig, kind: str, flat: int, step, lp: dict, x: torch.Tensor,
                enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer of the full-sequence forward, in its numerics scope (entered
    here, so that a checkpointed layer's recompute runs in it too): (x, the
    layer's aux loss, None without an MoE layer)."""
    with numerics_scope(step=step, layer=flat, static_layer=flat):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind == "ssm":
            return x + ssm_lib.ssm_forward(lp["ssm"], h, cfg.d_model, cfg.ssm, cfg.numerics,
                                           cfg.norm_eps), None
        x = x + attn.attend_full(lp["attn"], h, **_attn_kwargs(cfg, kind))
        x = _cross(cfg, lp, x, enc_out)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, aux = _ffn(cfg, lp, h)
        return x + y, aux


def _encoder_forward(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The whisper-style encoder over precomputed frame embeddings (B, T, D):
    bidirectional self-attention and an MLP per layer, then ``enc_norm``.
    Layer g runs in ``numerics_scope(layer=-1 - g)``, outside the decoder's
    flat indices, with no static layer."""
    x = frames
    for g in range(cfg.encoder_layers):
        lp = _layer(params["encoder"], g)
        with numerics_scope(layer=-1 - g):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + attn.attend_full(lp["attn"], h, **_attn_kwargs(cfg, "full"), causal=False)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp(lp["mlp"], h, cfg.mlp_act, cfg.numerics)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The encoder's entry point (whisper family): frame embeddings (B, T,
    D) -> encoder output (B, T, D) under ``cfg.numerics``, the ``enc_out``
    that ``decode_step`` attends to."""
    if not cfg.encoder_layers:
        raise ValueError("encode() requires cfg.encoder_layers > 0")
    return _encoder_forward(cfg, params, frames)


def _embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor, extra):
    """(x, enc_out): the token embeddings, with a VLM's projected patch
    prefix before them; the encoder's output where an audio model is given
    frames, else None."""
    x = embed(params["embed"], tokens)
    if cfg.vision_prefix and extra is not None:
        vis = dense(extra, params["vision_proj"], None, site="vision.proj")
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    enc_out = None
    if cfg.encoder_layers and extra is not None:
        enc_out = _encoder_forward(cfg, params, extra)
    return x, enc_out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            extra_embeddings: torch.Tensor | None = None,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V) (or (B, 1,
    V) with ``last_only``, sliced before the LM head), aux loss), as the JAX
    package's; aux is the float32 sum of the layers' MoE load-balancing
    losses, 0 without MoE layers.  ``extra_embeddings``: a VLM's (B, P, D)
    patch prefix (its P positions dropped from the logits) or an audio
    model's (B, T, D) encoder frames."""
    kinds, n_repeat = group_structure(cfg)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    step = current_scope().step
    x, enc_out = _embed_inputs(cfg, params, tokens, extra_embeddings)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_repeat):
        for i, kind in enumerate(kinds):
            body = partial(_layer_full, cfg, kind, g * len(kinds) + i, step)
            lp = _block_params(params, kind, i, g)
            if remat:
                x, a = checkpoint(body, lp, x, enc_out, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = body(lp, x, enc_out)
            if a is not None:
                aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    logits = unembed(x, _head(cfg, params))
    if cfg.vision_prefix and extra_embeddings is not None and not last_only:
        logits = logits[:, cfg.vision_prefix:]
    return logits, aux


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device: torch.device,
               per_slot: bool = False) -> tuple:
    """One ``KVCache`` (or ``SSMState`` for an SSM layer) per layer kind,
    leaves stacked over n_repeat; a sliding-window kind's ring holds
    min(capacity, window) slots.

    ``per_slot=True`` gives each batch row its own position (``length`` of
    shape (n_repeat, B)): the continuous-batching slot cache.  An SSM state
    has no position; its rows are per slot already.
    """
    kinds, n_repeat = group_structure(cfg)

    def one(kind):
        if kind == "ssm":
            c = ssm_lib.SSMState.zeros(batch, cfg.d_model, cfg.ssm, _dtype(cfg), device)
        else:
            c = attn.KVCache.zeros(batch, _kv_capacity(cfg, kind, capacity), cfg.n_kv_heads,
                                   cfg.head_dim, _dtype(cfg), device, per_slot=per_slot)
        return tree_map(lambda t: t.expand(n_repeat, *t.shape).clone(), c)

    return tuple(one(k) for k in kinds)


def _merge_active(old: tuple, new: tuple, active: torch.Tensor) -> tuple:
    """Keep ``new`` cache state only for active slots; inactive rows retain
    ``old`` bit for bit (positions do not advance, K/V writes are dropped).

    Leaves are stacked (n_repeat, B, ...); a leaf without a batch axis
    (a shared scalar position) passes through unmasked.
    """
    B = active.shape[0]

    def merge(o, n):
        if n.dim() >= 2 and n.shape[1] == B:
            return torch.where(active.reshape((1, B) + (1,) * (n.dim() - 2)), n, o)
        return n

    return tree_map(merge, old, new)


def _cache_position(cache: tuple):
    """The decode position: the first KV cache's length (a scalar, or (B,)
    per slot); None for a cache of SSM states only, which hold no position."""
    for c in cache:
        if isinstance(c, attn.KVCache):
            return c.length[0]
    return None


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, cache: tuple,
                enc_out: torch.Tensor | None = None,
                active: torch.Tensor | None = None) -> tuple[torch.Tensor, tuple]:
    """One serving step: token (B, 1) -> (logits (B, 1, V), new cache).

    ``enc_out`` ((B, T, D), from ``encode``): the encoder output the
    decoder layers cross-attend to; each layer projects its K and V anew
    at every step, as the JAX package's decode step does.  ``active`` ((B,) bool) is the continuous-batching slot mask: every row
    computes, but inactive rows' cache writes and position advances are
    rolled back; their logits are garbage the caller ignores.
    """
    kinds, n_repeat = group_structure(cfg)
    pos = _cache_position(cache)
    pos = None if pos is None else HostOnce(pos)  # read to the host once a step, if at all
    x = embed(params["embed"], token)
    per_group = []
    for g in range(n_repeat):
        new = []
        for i, kind in enumerate(kinds):
            lp = _block_params(params, kind, i, g)
            flat = g * len(kinds) + i
            with numerics_scope(step=pos, layer=flat, static_layer=flat):
                h = rms_norm(x, lp["ln1"], cfg.norm_eps)
                if kind == "ssm":
                    y, c = ssm_lib.ssm_decode(lp["ssm"], h, _layer(cache[i], g), cfg.d_model,
                                              cfg.ssm, cfg.numerics, cfg.norm_eps)
                    x = x + y
                    new.append(c)
                    continue
                y, c = attn.attend_decode(lp["attn"], h, _layer(cache[i], g),
                                          **_attn_kwargs(cfg, kind))
                x = _cross(cfg, lp, x + y, enc_out)
                h = rms_norm(x, lp["ln2"], cfg.norm_eps)
                x = x + _ffn(cfg, lp, h)[0]
            new.append(c)
        per_group.append(tuple(new))
    new_cache = tree_map(lambda *ls: torch.stack(ls), *per_group)
    if active is not None:
        new_cache = _merge_active(cache, new_cache, active)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(cfg, params)), new_cache


def prefill_with_cache(cfg: ModelConfig, params: dict, tokens: torch.Tensor, capacity: int,
                       extra_embeddings: torch.Tensor | None = None) -> tuple[torch.Tensor, tuple]:
    """One-shot prefill: last-position logits (B, 1, V) + a ready decode
    cache.  ``extra_embeddings`` as in ``forward``: a VLM's patch prefix
    takes cache positions before the tokens (``capacity`` counts them), an
    audio model's frames go through the encoder."""
    kinds, n_repeat = group_structure(cfg)
    x, enc_out = _embed_inputs(cfg, params, tokens, extra_embeddings)
    per_group = []
    for g in range(n_repeat):
        caches = []
        for i, kind in enumerate(kinds):
            lp = _block_params(params, kind, i, g)
            flat = g * len(kinds) + i
            with numerics_scope(layer=flat, static_layer=flat):
                h = rms_norm(x, lp["ln1"], cfg.norm_eps)
                if kind == "ssm":
                    y, c = ssm_lib.ssm_prefill(lp["ssm"], h, cfg.d_model, cfg.ssm,
                                               cfg.numerics, cfg.norm_eps)
                    x = x + y
                    caches.append(c)
                    continue
                y, c = attn.attend_prefill(lp["attn"], h, _kv_capacity(cfg, kind, capacity),
                                           **_attn_kwargs(cfg, kind))
                x = _cross(cfg, lp, x + y, enc_out)
                h = rms_norm(x, lp["ln2"], cfg.norm_eps)
                x = x + _ffn(cfg, lp, h)[0]
            caches.append(c)
        per_group.append(tuple(caches))
    cache = tree_map(lambda *ls: torch.stack(ls), *per_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, -1:, :], _head(cfg, params)), cache
