"""minitron-8b [dense] — width/depth-pruned Nemotron-4 [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, untied, the same
constants as the JAX package's ``configs/minitron_8b.py``.
(Source model uses squared-ReLU MLPs; we keep the zoo-uniform gated MLP and
note the substitution — structure/FLOPs are identical for roofline purposes.)
About 9.87 G parameters, 19.7 GB in bf16.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    mlp_act="swiglu",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
