"""amr-paper-100m: the paper's own end-to-end artifact, a ~100M-parameter
LM whose matmuls run under AMR-MUL numerics (the JAX package's
``configs/amr_paper.py``): the 2-digit border-8 design point the paper
highlights, in the low-rank form at rank 16.  The trainer's default arch."""
import dataclasses

from repro_torch.numerics import AMRNumerics

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="amr-paper-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=32000,
    mlp_act="swiglu",
    tie_embeddings=True,
    numerics=AMRNumerics("amr_lowrank", border=8, rank=16),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                               head_dim=16, d_ff=128, vocab=256)
