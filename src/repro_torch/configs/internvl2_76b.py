"""internvl2-76b [vlm] — InternViT frontend + Llama3-70B-class LM backbone
[arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, untied, the same
constants as the JAX package's ``configs/internvl2_76b.py``.  The vision
frontend is a stub: 256 precomputed patch embeddings a sample go through
the exact ``vision.proj`` dense and are prepended to the token sequence.
About 70.6 G parameters, 141 GB in bf16: one 80 GB card serves it at full
width with its depth cut.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
    mlp_act="swiglu",
    vision_prefix=256,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, vision_prefix=8)
