"""zamba2-1.2b [hybrid] — Mamba2 backbone + zamba-style *shared* attention
blocks [arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64, the
same constants as the JAX package's ``configs/zamba2_1p2b.py``: 2 groups of
(18 Mamba2 + 1 shared attention) = 38 layers; the attention + MLP block
re-uses ONE parameter set (``params["shared"]``) at each of its
applications.
"""
import dataclasses

from repro_torch.configs.base import LayerPattern, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    pattern=LayerPattern(kinds=("ssm",) * 18 + ("shared_attn",), n_repeat=2),
    ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, expand=2),
    mlp_act="geglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        pattern=LayerPattern(kinds=("ssm", "shared_attn"), n_repeat=2),
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, chunk=16),
    )
