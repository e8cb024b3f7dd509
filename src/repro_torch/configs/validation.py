"""Structural validation of ``ModelConfig`` instances.

The port of the JAX package's ``configs/validation.py``: ``validate_config``
checks every invariant the model assembly relies on (GQA head grouping,
the SSM's heads and groups, the MoE's top-k, the encoder's frames, the
vision prefix) and raises ``ValueError`` naming the config's fields,
before a shrink that breaks one fails deep in a reshape.
"""
from __future__ import annotations

from .base import ModelConfig

__all__ = ["validate_config"]

def _fail(cfg: ModelConfig, msg: str) -> None:
    raise ValueError(f"config {cfg.name!r}: {msg}")


def validate_config(cfg: ModelConfig) -> ModelConfig:
    """Check cross-field invariants; returns ``cfg`` so calls can chain."""
    if cfg.n_layers <= 0 or cfg.d_model <= 0 or cfg.vocab <= 0:
        _fail(cfg, f"n_layers/d_model/vocab must be positive, got "
                   f"{cfg.n_layers}/{cfg.d_model}/{cfg.vocab}")

    kinds = cfg.layer_kinds()
    if cfg.pattern is not None and cfg.pattern.n_layers != cfg.n_layers:
        _fail(cfg, f"pattern covers {cfg.pattern.n_layers} layers "
                   f"({cfg.pattern.kinds} x {cfg.pattern.n_repeat}) but "
                   f"n_layers={cfg.n_layers}")

    has_attn = any(k in ("full", "swa", "shared_attn", "cross") for k in kinds)
    if has_attn or cfg.encoder_layers:
        if cfg.n_heads <= 0 or cfg.n_kv_heads <= 0 or cfg.head_dim <= 0:
            _fail(cfg, f"attention needs positive n_heads/n_kv_heads/head_dim, "
                       f"got {cfg.n_heads}/{cfg.n_kv_heads}/{cfg.head_dim}")
        if cfg.n_heads % cfg.n_kv_heads:
            _fail(cfg, f"GQA grouping needs n_kv_heads | n_heads, got "
                       f"n_heads={cfg.n_heads}, n_kv_heads={cfg.n_kv_heads}")
    if any(k == "swa" for k in kinds) and cfg.sliding_window <= 0:
        _fail(cfg, f"'swa' layers need sliding_window > 0, got "
                   f"{cfg.sliding_window}")

    if any(k == "ssm" for k in kinds):
        if cfg.ssm is None:
            _fail(cfg, "'ssm' layers need cfg.ssm (SSMConfig)")
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        if d_inner % s.head_dim:
            _fail(cfg, f"SSM needs head_dim | d_inner: d_inner = expand * "
                       f"d_model = {s.expand} * {cfg.d_model} = {d_inner}, "
                       f"head_dim={s.head_dim}")
        n_heads = d_inner // s.head_dim
        if n_heads % s.n_groups:
            _fail(cfg, f"SSM needs n_groups | (d_inner/head_dim): "
                       f"{n_heads} heads, n_groups={s.n_groups}")
        if s.d_state <= 0 or s.conv_width <= 0 or s.chunk <= 0:
            _fail(cfg, f"SSM d_state/conv_width/chunk must be positive, got "
                       f"{s.d_state}/{s.conv_width}/{s.chunk}")

    if cfg.moe is not None:
        m = cfg.moe
        if m.n_experts <= 0 or m.d_ff_expert <= 0:
            _fail(cfg, f"MoE needs positive n_experts/d_ff_expert, got "
                       f"{m.n_experts}/{m.d_ff_expert}")
        if not 0 < m.top_k <= m.n_experts:
            _fail(cfg, f"MoE needs 0 < top_k <= n_experts, got "
                       f"top_k={m.top_k}, n_experts={m.n_experts}")
    elif cfg.family == "moe":
        _fail(cfg, "family 'moe' but cfg.moe is None")

    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        _fail(cfg, f"family {cfg.family!r} but cfg.ssm is None")
    if cfg.family == "audio" and not cfg.encoder_layers:
        _fail(cfg, "family 'audio' but encoder_layers == 0")
    if cfg.encoder_layers and cfg.encoder_frames <= 0:
        _fail(cfg, f"encoder_layers={cfg.encoder_layers} needs "
                   f"encoder_frames > 0, got {cfg.encoder_frames}")
    if cfg.family == "vlm" and cfg.vision_prefix <= 0:
        _fail(cfg, "family 'vlm' but vision_prefix == 0")
    return cfg
