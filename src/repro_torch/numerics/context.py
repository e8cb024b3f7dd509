"""Ambient numerics scope: the step and layer a matmul runs at.

The port of the scope half of the JAX package's ``numerics/context.py``.
``numerics_scope(step=..., layer=..., static_layer=...)`` is entered by
``train.steps.loss_fn`` (the training step), by the model around each layer
(its flat index) and by ``decode_step`` (the cache position);
``approx_matmul`` and the model's sites read ``static_layer``, the flat
layer index that a per-layer policy resolves against
(``approx_matmul.resolve_numerics``).

Scopes nest: an inner value overrides, an absent one inherits.  The stack
is thread-local, so two threads running models never see each other's
entries.  Not ported yet: the PRNG half (``root_key``, ``noise_key``),
which only ``amr_noise`` reads, and the audit and shape-probe channels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

__all__ = ["NumericsScope", "numerics_scope", "current_scope"]


@dataclasses.dataclass(frozen=True)
class NumericsScope:
    """``step``: the training step or decode position (an int or a tensor);
    ``layer``: the flat layer index; ``static_layer``: the same as a plain
    int, the coordinate per-layer policies resolve against (None outside
    the decoder's layers)."""

    step: Any = None
    layer: Any = None
    static_layer: int | None = None


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextlib.contextmanager
def numerics_scope(*, step=None, layer=None, static_layer=None):
    """Provide step / layer coordinates to the matmuls run inside."""
    cur = current_scope()
    stack = _stack()
    stack.append(NumericsScope(
        step=step if step is not None else cur.step,
        layer=layer if layer is not None else cur.layer,
        static_layer=static_layer if static_layer is not None else cur.static_layer))
    try:
        yield
    finally:
        stack.pop()


def current_scope() -> NumericsScope:
    stack = _stack()
    return stack[-1] if stack else NumericsScope()
