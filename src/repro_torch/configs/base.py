"""Model architecture descriptor, mirroring the JAX package's ``configs/base.py``.

Only the fields the ported paths (the dense decoder, the Mamba2 SSM and
hybrid families, the MoE family, the audio encoder-decoder and the VLM's
vision prefix) read are kept; they carry
the JAX package's names and defaults so that a parity test can compare
the two configs field by field.  ``numerics`` holds one ``AMRNumerics``
design point for every matmul of the model, or a site- and layer-resolved
policy (``numerics/policy.py``: ``UniformPolicy``, ``PerLayerPolicy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

from repro_torch.numerics import AMRNumerics


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden size
    # the JAX package's dispatch-buffer strategy; the port runs two forms:
    #   "replicate" — one sorted-capacity dispatch, the expert products
    #                 through the numerics policy (``moe._moe_forward_global``)
    #   "local"     — the JAX package's shard-local dispatch without a mesh:
    #                 the same dispatch with exact expert products, the
    #                 numerics ignored (``moe._moe_forward_local``)
    dispatch_shard: str = "replicate"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    """Heterogeneous depth as repeated groups of block kinds: ``kinds`` is
    one group's mixer sequence, repeated ``n_repeat`` times."""

    kinds: tuple[str, ...]
    n_repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.kinds) * self.n_repeat


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0              # >0: width for 'swa' layers
    pattern: LayerPattern | None = None  # None -> homogeneous default_mixer
    moe: MoEConfig | None = None         # set: an MoE layer in place of each MLP
    ssm: SSMConfig | None = None
    mlp_act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    # enc-dec (whisper): the encoder takes precomputed frame embeddings (a stub frontend)
    encoder_layers: int = 0
    encoder_frames: int = 0              # the encoder's fixed sequence (1500 for whisper)
    # vlm: a prefix of precomputed patch embeddings (a stub frontend)
    vision_prefix: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    numerics: Any = AMRNumerics("exact")  # AMRNumerics or a NumericsPolicy
    default_mixer: str = "full"
    # remat policy for training: 'none' | 'block' (recompute each layer in backward)
    remat: str = "block"

    def layer_kinds(self) -> tuple[str, ...]:
        if self.pattern is not None:
            return self.pattern.kinds * self.pattern.n_repeat
        return (self.default_mixer,) * self.n_layers
