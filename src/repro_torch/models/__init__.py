"""Models of the port: layers, attention with a per-slot KV cache and
cross-attention, the Mamba2 SSM mixer, the shared attention block, the MoE
layer, the audio encoder, and the model entry points."""
from .model import decode_step, encode, forward, group_structure, init_cache, init_params, \
    prefill_with_cache, unread_params

__all__ = ["forward", "encode", "decode_step", "init_params", "init_cache", "group_structure",
           "prefill_with_cache", "unread_params"]
