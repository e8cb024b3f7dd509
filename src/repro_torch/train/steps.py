"""prefill_step / serve_step — the serving steps of the JAX package's
``train/steps.py``, run eagerly under ``torch.inference_mode``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward


def make_prefill_step(cfg: ModelConfig):
    """Prefill returning only the last position's logits (B, V)."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        return forward(cfg, params, batch["tokens"], last_only=True)[:, 0, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, with_logits: bool = False):
    """One greedy decode step over a (possibly slot-batched) cache.

    ``batch`` holds ``token`` (B, 1) and optionally ``active`` (B,) bool, the
    slot mask passed to ``decode_step``.  The argmax runs on the card.
    ``with_logits=True`` also returns the final-position float32 logits.
    """

    @torch.inference_mode()
    def serve_step(params, cache, batch):
        logits, cache = decode_step(cfg, params, batch["token"], cache, batch.get("active"))
        last = logits[:, -1]
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        if with_logits:
            return next_tok, last.float(), cache
        return next_tok, cache

    return serve_step
