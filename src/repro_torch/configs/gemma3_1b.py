"""gemma3-1b [dense] — 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, window 512, the same
constants as the JAX package's ``configs/gemma3_1b.py``: two groups of 13
layers (11 sliding-window + 2 global), rope theta 1e6, GeGLU, tied
embeddings.
"""
import dataclasses

from repro_torch.configs.base import LayerPattern, ModelConfig

_GROUP = ("swa",) * 5 + ("full",) + ("swa",) * 5 + ("full",) + ("swa",)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    sliding_window=512,
    pattern=LayerPattern(kinds=_GROUP, n_repeat=2),
    rope_theta=1e6,
    mlp_act="geglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8,
        pattern=LayerPattern(kinds=("swa", "full"), n_repeat=2))
