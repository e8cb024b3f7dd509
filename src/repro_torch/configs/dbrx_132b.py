"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4,
the same constants as the JAX package's ``configs/dbrx_132b.py``, which
registers it with ``dispatch_shard="local"``: exact expert products.  At
about 263 GB of bf16 weights it does not fit one 80 GB card; the port holds
it against the JAX package at its reduced size (``reduced()``: the MoE
default, ``"replicate"``, whose expert products follow the numerics).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, dispatch_shard="local"),
    mlp_act="swiglu",
    rope_theta=5e5,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
