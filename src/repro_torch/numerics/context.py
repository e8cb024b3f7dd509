"""Ambient numerics scope: the step, layer and unit a matmul runs at, and
the ``amr_noise`` PRNG keys derived from them.

The port of the JAX package's ``numerics/context.py``.
``numerics_scope(step=..., layer=..., unit=..., static_layer=...)`` is
entered by ``train.steps.loss_fn`` (the training step), by the model around
each layer (its flat index), by ``decode_step`` (the cache position: a
scalar, or a (B,) vector of per-slot positions) and by the MoE layer around
each request's dispatch; ``approx_matmul`` and the model's sites read
``static_layer``, the flat layer index that a per-layer policy resolves
against (``approx_matmul.resolve_numerics``), and ``amr_noise`` folds the
rest into its key (``noise_key``).

Scopes nest: an inner value overrides, an absent one inherits.  The stack
is thread-local, so two threads running models never see each other's
entries.

**Audit.**  The scope also carries the conformance audit channel
(``audit=``): an :class:`AuditTrace` that, while in scope, makes
``approx_matmul`` compare every call site's output with a reference (the
mode's bit-exact ``registry.ModeSpec.oracle``, or the exact float matmul)
and record the per-site difference.  The port runs eagerly, so the record
is made in the call itself (JAX records through ``jax.debug.callback``);
the difference is read to the host only while an audit is in scope.  Not
ported: the shape-probe channel, which comes with its consumer, the
saturation proof.

**Keys.**  JAX's threefry stream is not reproduced: a key here is a 64-bit
integer, ``root_key(seed)`` mixed by ``fold_in`` with the call-site id
(``_site_id``, the JAX package's crc32, copied exactly), the step, the
layer and the unit, each under its own tag, so that an absent coordinate
(skipped) and a coordinate of 0 give different streams.  ``amr_noise``
seeds one ``torch.Generator`` on the operand's device from a key
(``approx_matmul._normal_draw``), never the global RNG, so a recomputed
layer (``torch.utils.checkpoint`` with ``preserve_rng_state=False``) draws
the same noise.  A (B,) step gives a batch of keys, one per request, each
the key a solo decode of that request would derive.

**Host reads.**  The step and the positions live on the device; a scope
holds a tensor as a :class:`HostOnce`, which reads it to the host at its
first use and keeps the value, so a training or decode step syncs at most
once however many sites draw noise, and not at all under other modes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Any

import torch

__all__ = ["NumericsScope", "numerics_scope", "request_scope", "current_scope", "HostOnce",
           "AuditTrace", "root_key", "fold_in", "noise_key"]

_MASK64 = (1 << 64) - 1
# one tag per coordinate: an absent coordinate is skipped, and a present one
# of value 0 still changes the key
_TAG_SITE, _TAG_STEP, _TAG_LAYER, _TAG_UNIT = 1, 2, 3, 4


class HostOnce:
    """A device tensor read to the host at its first ``value()`` (a Python
    int, or a tuple of ints for a vector), then kept."""

    __slots__ = ("_tensor", "_value")

    def __init__(self, tensor: torch.Tensor):
        self._tensor = tensor
        self._value = None

    def value(self):
        if self._value is None:
            t = self._tensor.detach()
            self._value = tuple(int(v) for v in t.reshape(-1).tolist()) if t.dim() else int(t)
        return self._value


class _Element:
    """Element ``i`` of a vector coordinate, read to the host (once, by its
    parent) only when a draw needs it."""

    __slots__ = ("_parent", "_i")

    def __init__(self, parent, i: int):
        self._parent, self._i = parent, i

    def value(self):
        return _value(self._parent)[self._i]


def _length(v) -> int | None:
    """The length of a vector coordinate, None for a scalar or absent one
    (no host read: a tensor's shape is on the host)."""
    if isinstance(v, HostOnce):
        return v._tensor.shape[0] if v._tensor.dim() else None
    return len(v) if isinstance(v, (list, tuple)) else None


def _host(v):
    """A scope coordinate as it is stored: tensors wrapped in ``HostOnce``."""
    return HostOnce(v) if isinstance(v, torch.Tensor) else v


def _value(v):
    """A stored coordinate's host value: None, an int, or a tuple of ints."""
    if isinstance(v, (HostOnce, _Element)):
        return v.value()
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return None if v is None else int(v)


class AuditTrace:
    """Per-call-site record of |mode output - reference output| (JAX
    ``AuditTrace``).

    ``sites`` maps a call-site label to ``{"calls", "max_abs_diff",
    "sum_abs_diff"}``; where the scope carries a layer coordinate, the same
    record accumulates per ``(site, layer)`` in ``coords``.

    ``compare`` selects the reference:
      * ``"oracle"`` (default): the mode's bit-exact ``ModeSpec.oracle``,
        diffed in integer-product-grid steps (a real mismatch records
        >= 1.0): the conformance matrix's inject-vs-table proof;
      * ``"exact"``: the exact float matmul of the same operands; the diff
        is the mode's approximation error and ``sum_abs_diff`` its mass.
    """

    def __init__(self, compare: str = "oracle"):
        if compare not in ("oracle", "exact"):
            raise ValueError(
                f"AuditTrace compare must be 'oracle' or 'exact', got {compare!r}")
        self.compare = compare
        self.sites: dict[str, dict[str, Any]] = {}
        self.coords: dict[tuple[str, int], dict[str, Any]] = {}

    @staticmethod
    def _accum(ent: dict, diff: float, mass: float) -> None:
        ent["calls"] += 1
        ent["max_abs_diff"] = max(ent["max_abs_diff"], diff)
        ent["sum_abs_diff"] += mass

    def record(self, site: str, diff, layer=None, mass=None) -> None:
        d = float(diff)
        m = d if mass is None else float(mass)
        zero = {"calls": 0, "max_abs_diff": 0.0, "sum_abs_diff": 0.0}
        self._accum(self.sites.setdefault(site, dict(zero)), d, m)
        if layer is not None:
            self._accum(self.coords.setdefault((site, int(layer)), dict(zero)), d, m)

    @property
    def max_abs_diff(self) -> float:
        return max((e["max_abs_diff"] for e in self.sites.values()), default=0.0)

    @property
    def calls(self) -> int:
        return sum(e["calls"] for e in self.sites.values())

    def bit_exact(self) -> bool:
        return self.max_abs_diff == 0.0


@dataclasses.dataclass(frozen=True)
class NumericsScope:
    """``step``: the training step or decode position (an int, a (B,)
    vector of per-request positions, or a ``HostOnce`` of either);
    ``layer``: the flat layer index; ``unit``: the instance of a sub-layer
    that shares one call site (a request of the MoE layer's per-request
    dispatch); ``audit``: an ``AuditTrace`` recording every call site's
    difference to its reference, or None; ``static_layer``: the flat layer
    index as a plain int, the coordinate per-layer policies resolve against
    (None outside the decoder's layers)."""

    step: Any = None
    layer: Any = None
    unit: Any = None
    audit: Any = None
    static_layer: int | None = None


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextlib.contextmanager
def numerics_scope(*, step=None, layer=None, unit=None, audit=None, static_layer=None):
    """Provide step / layer / unit coordinates (and the optional audit
    channel) to the matmuls run inside."""
    cur = current_scope()
    stack = _stack()
    stack.append(NumericsScope(
        step=_host(step) if step is not None else cur.step,
        layer=_host(layer) if layer is not None else cur.layer,
        unit=_host(unit) if unit is not None else cur.unit,
        audit=audit if audit is not None else cur.audit,
        static_layer=static_layer if static_layer is not None else cur.static_layer))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def request_scope(r: int, n: int):
    """The scope of request ``r`` of ``n`` where a call site runs one request
    at a time: its own position where the step is a vector of ``n``
    per-request positions (what a solo decode of the request sees), else
    ``unit=r``, so that the requests draw from different streams."""
    step = current_scope().step
    if _length(step) == n:
        with numerics_scope(step=_Element(step, r)):
            yield
    else:
        with numerics_scope(unit=r):
            yield


def current_scope() -> NumericsScope:
    stack = _stack()
    return stack[-1] if stack else NumericsScope()


def _site_id(site: str) -> int:
    """Static 31-bit id of a call-site label (the JAX package's, exactly)."""
    return zlib.crc32(site.encode()) & 0x7FFFFFFF


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def root_key(seed: int) -> int:
    """The PRNG root every ``amr_noise`` key chain starts from."""
    return _splitmix64(int(seed) & _MASK64)


def fold_in(key: int, tag: int, data: int) -> int:
    """Mix ``data`` (taken modulo 2**32, as JAX's ``fold_in`` takes it) into
    ``key`` under the coordinate's ``tag``."""
    return _splitmix64(key ^ _splitmix64((tag << 32) | (int(data) & 0xFFFFFFFF)))


def noise_key(seed: int, site: str | None = None):
    """The ``amr_noise`` key of one call site: ``root_key(seed)`` with the
    site, then the ambient step, layer and unit folded in, each skipped
    when absent.  A (B,) step gives a tuple of B keys, one per request,
    each the key a solo decode of that request at its position derives."""
    key = root_key(seed)
    if site:
        key = fold_in(key, _TAG_SITE, _site_id(site))
    scope = current_scope()
    step, layer, unit = _value(scope.step), _value(scope.layer), _value(scope.unit)

    def rest(k: int) -> int:
        if layer is not None:
            k = fold_in(k, _TAG_LAYER, layer)
        if unit is not None:
            k = fold_in(k, _TAG_UNIT, unit)
        return k

    if isinstance(step, tuple):
        return tuple(rest(fold_in(key, _TAG_STEP, s)) for s in step)
    if step is not None:
        key = fold_in(key, _TAG_STEP, step)
    return rest(key)
