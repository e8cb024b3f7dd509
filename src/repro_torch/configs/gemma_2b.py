"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (GQA kv=1 — MQA) d_ff=16384 vocab=256000, the same
constants as the JAX package's ``configs/gemma_2b.py``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    mlp_act="geglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256)
