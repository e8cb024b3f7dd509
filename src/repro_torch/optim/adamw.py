"""AdamW with float32 master weights and moments over bf16 params.

The port of the JAX package's ``optim/adamw.py``: the same state
(``mu``, ``nu``, ``master`` mirroring the params tree, and ``count``) and
the same update: global-norm clip at 1.0, bias correction, decoupled
weight decay on the float32 master, then a cast to the param dtype.  Plain
functions over the params dict, as the port's models are, so that a
checkpoint's leaf keys match the JAX package's (``opt/mu/...``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.tree import tree_leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    mu: Any
    nu: Any
    master: Any           # float32 master copy of the params
    count: torch.Tensor   # int32 scalar


def adamw_init(params: Any) -> AdamWState:
    """Zero moments, a float32 copy of the params (never aliasing a float32
    param leaf), count 0, on the params' device."""
    leaf = tree_leaves(params)[0]
    return AdamWState(
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        count=torch.zeros((), dtype=torch.int32, device=leaf.device))


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """The float32 norm of all leaves, their squares summed in the tree's
    leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> tuple[Any, AdamWState]:
    """One AdamW step -> (params, state), the gradients clipped to
    ``grad_clip`` by their ``global_norm``.

    ``state`` and ``params`` are donated, as the JAX launcher donates the
    train state: their leaves are updated in place, one leaf at a time, and
    returned.  So the optimizer state is held once, plus a few temporaries
    the size of one leaf.  The bits equal those of the functional form
    ``mu' = b1*mu + (1-b1)*g``, ``nu' = b2*nu + (1-b2)*g*g``,
    ``master' = master - lr*((mu'/c1) / (sqrt(nu'/c2) + eps) + wd*master)``,
    ``p' = master'`` cast to p's dtype: each in-place op is the same
    elementwise op on the same operands.
    """
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for g, mu, nu, master, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                    tree_leaves(state.nu), tree_leaves(state.master),
                                    tree_leaves(params)):
        g = g.to(torch.float32) * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_(((1 - b2) * g).mul_(g))
        del g
        step = (mu / c1).div_((nu / c2).sqrt_().add_(eps))
        step.add_(weight_decay * master)
        master.sub_(step.mul_(lr))
        del step
        p.copy_(master)
    return params, AdamWState(state.mu, state.nu, state.master, count)
