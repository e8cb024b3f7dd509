"""train_step / prefill_step / serve_step: the port of the JAX package's
``train/steps.py``, run eagerly.

  * train_*   — loss, gradient and AdamW update (optionally with microbatch
                gradient accumulation);
  * prefill_* — full-sequence forward returning the last logits;
  * serve_*   — one decode step against a KV or SSM cache.

Under the AMR modes a training step's forward runs the hand kernels and
its backward the straight-through surrogate (``numerics/approx_matmul.py``);
an SSM layer's scan runs the SSD kernel forward and its backward kernel
(``kernels/ssd_scan``).  The leaves that no computation reads
(``models.unread_params``: a Mamba2 block's ``ln2``, a shared-attention
layer's own ``ln1``, ``ln2`` and ``mlp``; and, in a batch without
``extra`` embeddings, the encoder, cross-attention and vision leaves of an
audio or VLM model, which then trains decoder only) get zero gradients, as
``jax.grad`` gives them, and AdamW decays them as the JAX package's does;
every other leaf must receive a gradient.  A batch's optional ``extra``
((B, T, D): a VLM's patch prefix, an audio model's encoder frames) goes to
``forward`` as its ``extra_embeddings``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, group_structure, init_params, unread_params
from repro_torch.models.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from repro_torch.numerics import numerics_scope
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_warmup, global_norm

@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: torch.Tensor  # int32 scalar


def make_train_state(cfg: ModelConfig, seed: int = 0, *,
                     device: str | torch.device = "cuda") -> TrainState:
    """Random weights from ``seed`` on ``device``, fresh AdamW state, step 0."""
    params = init_params(cfg, seed, device=device)
    return TrainState(params, adamw_init(params),
                      torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device))


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a layer kind the port
    does not run (``group_structure``); every kind it runs it can train."""
    group_structure(cfg)


def loss_fn(cfg: ModelConfig, params, tokens: torch.Tensor, targets: torch.Tensor,
            extra: torch.Tensor | None = None, aux_weight: float = 0.01, step=None, *,
            with_logits: bool = False):
    """Mean float32 next-token NLL plus ``aux_weight * aux`` -> (loss, aux),
    or (loss, (aux, logits)) with ``with_logits``.  ``extra``: the forward's
    extra embeddings.  ``step`` enters the numerics scope.  Raises for a
    layer kind the port does not run."""
    if torch.is_grad_enabled():
        check_trainable(cfg)
    with numerics_scope(step=step):
        logits, aux = forward(cfg, params, tokens, extra)
    ll = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(ll, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean() + aux_weight * aux
    return (loss, (aux, logits)) if with_logits else (loss, aux)


def _grads_of(cfg: ModelConfig, params, tokens, targets, extra, step):
    """(loss, aux, grads): zeros for the leaves no computation reads (those
    of the encoder, cross-attention and vision prefix too where ``extra`` is
    None), and every other parameter must get a gradient."""
    unread = unread_params(cfg, with_extra=extra is not None)
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(cfg, ps, tokens, targets, extra, step=step)
        items = tree_items(ps)
        read = iter(torch.autograd.grad(loss, [p for path, p in items if path not in unread]))
    grads = [torch.zeros_like(p) if path in unread else next(read) for path, p in items]
    return loss.detach(), aux.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, microbatch: int | None = None):
    """Returns train_step(state, batch) -> (state, metrics); ``batch`` holds
    ``tokens`` and ``targets`` (B, S) tensors on the state's device, and
    optionally ``extra`` (B, T, D) embeddings.
    ``state`` is donated: the returned state holds its params and optimizer
    leaves, updated in place (``optim.adamw_update``).
    ``metrics``: the JAX package's ``loss``, ``aux`` and ``lr``, and the
    gradients' ``grad_norm`` (before clipping).

    ``microbatch``: split the batch (``extra`` with it) into that many
    sequential micro-steps and accumulate their gradients in float32.
    """
    check_trainable(cfg)

    def train_step(state: TrainState, batch: dict):
        tokens, targets, extra = batch["tokens"], batch["targets"], batch.get("extra")
        if microbatch and microbatch > 1:
            B = tokens.shape[0]
            if B % microbatch:
                raise ValueError(
                    f"global batch size {B} is not divisible by "
                    f"microbatch={microbatch}; pick a microbatch count that "
                    f"divides the batch (e.g. {B} % {microbatch} == 0)")
            mbs = B // microbatch
            loss = aux = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(microbatch):
                rows = slice(i * mbs, (i + 1) * mbs)
                e = None if extra is None else extra[rows]
                l, a, g = _grads_of(cfg, state.params, tokens[rows], targets[rows], e,
                                    state.step)
                grads = tree_map(torch.add, grads, g)
                loss, aux = loss + l, aux + a
            loss, aux = loss / microbatch, aux / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        else:
            loss, aux, grads = _grads_of(cfg, state.params, tokens, targets, extra, state.step)
        lr = cosine_warmup(state.step, peak_lr=peak_lr, warmup=warmup, total=total_steps)
        params, opt = adamw_update(grads, state.opt, state.params, lr)
        metrics = {"loss": loss, "aux": aux, "lr": lr, "grad_norm": global_norm(grads)}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def make_grads_step(cfg: ModelConfig):
    """Forward and backward only (one microbatch's worth) -> grads."""
    check_trainable(cfg)

    def grads_step(params, batch):
        return _grads_of(cfg, params, batch["tokens"], batch["targets"], batch.get("extra"),
                         None)[2]

    return grads_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill returning only the last position's logits (B, V)."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        return forward(cfg, params, batch["tokens"], batch.get("extra"),
                       last_only=True)[0][:, 0, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, with_logits: bool = False):
    """One greedy decode step over a (possibly slot-batched) cache.

    ``batch`` holds ``token`` (B, 1) and optionally ``enc_out`` (an encoder
    output) and ``active`` (B,) bool, the slot mask, passed to
    ``decode_step``.  The argmax runs on the card.
    ``with_logits=True`` also returns the final-position float32 logits.
    """

    @torch.inference_mode()
    def serve_step(params, cache, batch):
        logits, cache = decode_step(cfg, params, batch["token"], cache, batch.get("enc_out"),
                                    batch.get("active"))
        last = logits[:, -1]
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        if with_logits:
            return next_tok, last.float(), cache
        return next_tok, cache

    return serve_step
