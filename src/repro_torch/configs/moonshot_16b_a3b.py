"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
(fine-grained experts), the same constants as the JAX package's
``configs/moonshot_16b_a3b.py``; like it, without the source model's
shared experts.  Registered with ``dispatch_shard="local"`` (exact expert
products); ``dataclasses.replace`` of its ``moe`` with ``"replicate"``
gives the form whose expert sites follow the numerics.  About 28.05 G
parameters, 56.1 GB in bf16: the one MoE config that one 80 GB card
serves at full width.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, dispatch_shard="local"),
    mlp_act="swiglu",
    rope_theta=5e4,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=256, moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32))
