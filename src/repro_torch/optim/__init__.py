"""Optimizers of the port: AdamW with float32 master weights, and the LR
schedule."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm", "cosine_warmup"]
