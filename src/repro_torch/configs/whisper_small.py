"""whisper-small [audio] — enc-dec transformer backbone [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768 12H (kv=12) d_ff=3072 gelu
vocab=51865, tied embeddings, the same constants as the JAX package's
``configs/whisper_small.py``.  The conv/mel frontend is a stub: the
encoder takes 1500 precomputed frame embeddings (``encode``), and every
decoder layer cross-attends to its output.  About 0.29 G parameters.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder depth; encoder_layers below
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    mlp_act="gelu",
    encoder_layers=12,
    encoder_frames=1500,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, encoder_layers=2, encoder_frames=16)
