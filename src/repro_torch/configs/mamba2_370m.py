"""mamba2-370m [ssm] — attention-free SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 (attention-free) d_ff=0 vocab=50280, d_state=128, the same
constants as the JAX package's ``configs/mamba2_370m.py``: pure Mamba2
blocks with no MLP (the expand-2 in-projection plays the FFN role).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,        # unused (attention-free); kept for config uniformity
    n_kv_heads=16,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    default_mixer="ssm",
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, chunk=16),
    )
