"""qwen3-32b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, untied, the same
constants as the JAX package's ``configs/qwen3_32b.py``.
head_dim=128 (Qwen3 attention operates wider than d_model: 64*128=8192).
About 32.8 G parameters, 65.5 GB in bf16.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    mlp_act="swiglu",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
