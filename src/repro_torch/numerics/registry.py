"""Numerics-mode registry: the single source of truth for dispatch.

The port of the JAX package's ``numerics/registry.py``.  Each
``matmul_amr_*`` implementation registers itself as a :class:`ModeSpec`
(at the bottom of ``approx_matmul.py``, in the JAX package's order),
``AMRNumerics`` validates its mode and parameters against the registry at
construction, and everything that needs the list of valid modes (dispatch,
CLI ``choices``, error messages) derives it from :func:`mode_names`.
Callers never compare mode names.

Registered impls share one calling convention::

    impl(a, b, numerics, *, key=None, site=None) -> torch.Tensor

with ``a: (..., M, K)``, ``b: (K, N)`` or a batched ``(..., K, N)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["ModeSpec", "register_mode", "get_mode", "mode_names", "is_exact_mode",
           "validate_policy", "default_policy"]

Impl = Callable[..., Any]

@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One numerics mode: name, implementation, and its parameter contract.

    ``required_params`` are ``AMRNumerics`` fields that must be non-None;
    ``validate`` is an extra check run at policy construction.
    ``oracle`` is an optional bit-exact reference ``(a, b, numerics) ->
    Tensor`` of the same products: under ``numerics_scope(audit=
    AuditTrace())`` ``approx_matmul`` evaluates it beside ``impl`` at every
    call site and records the difference (the conformance inject audit).
    ``defaults`` (field -> value) are applied by :func:`default_policy`;
    ``accepts_params`` names the fields the mode consumes beyond its
    required ones (:func:`default_policy` drops overrides of the others).
    ``exact`` marks the mode whose impl is the exact float matmul.
    """

    name: str
    impl: Impl
    required_params: tuple[str, ...] = ()
    description: str = ""
    validate: Callable[[Any], None] | None = None
    oracle: Impl | None = None
    defaults: tuple[tuple[str, Any], ...] = ()
    accepts_params: tuple[str, ...] = ()
    exact: bool = False


# registration order is the canonical order of CLIs and error messages
_REGISTRY: dict[str, ModeSpec] = {}


def register_mode(name: str, impl: Impl, *, required_params: tuple[str, ...] = (),
                  description: str = "", validate: Callable[[Any], None] | None = None,
                  oracle: Impl | None = None, defaults: dict[str, Any] | None = None,
                  accepts_params: tuple[str, ...] = (), exact: bool = False) -> ModeSpec:
    """Register a numerics mode.  Names are unique: re-registration raises."""
    if not name or not isinstance(name, str):
        raise ValueError(f"mode name must be a non-empty string, got {name!r}")
    if name in _REGISTRY:
        raise ValueError(f"numerics mode {name!r} is already registered")
    spec = ModeSpec(name=name, impl=impl, required_params=tuple(required_params),
                    description=description, validate=validate, oracle=oracle,
                    defaults=tuple(sorted((defaults or {}).items())),
                    accepts_params=tuple(accepts_params), exact=exact)
    _REGISTRY[name] = spec
    return spec


def mode_names() -> tuple[str, ...]:
    """Valid mode names, in registration (canonical) order."""
    return tuple(_REGISTRY)


def get_mode(name: str) -> ModeSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown numerics mode {name!r}; valid modes: {mode_names()}")
    return spec


def is_exact_mode(name: str) -> bool:
    """Whether a registered mode's impl is the exact float matmul."""
    return get_mode(name).exact


def validate_policy(numerics: Any) -> None:
    """Validate one ``AMRNumerics`` or every entry a policy can resolve to
    (``policies()``) against the registry."""
    entries = numerics.policies() if hasattr(numerics, "policies") else (numerics,)
    for nm in entries:
        spec = get_mode(nm.mode)
        for p in spec.required_params:
            if getattr(nm, p, None) is None:
                raise ValueError(f"numerics mode {nm.mode!r} requires parameter {p!r} "
                                 f"(got None); required params: {spec.required_params}")
        if spec.validate is not None:
            spec.validate(nm)


def default_policy(mode: str, **overrides: Any) -> Any:
    """A representative ``AMRNumerics`` for ``mode`` from its declared
    defaults; overrides of fields the mode does not take, and None values,
    are dropped."""
    from .approx_matmul import AMRNumerics  # lazy: the registry loads first

    spec = get_mode(mode)
    kwargs: dict[str, Any] = dict(spec.defaults)
    accepted = set(spec.required_params) | set(spec.accepts_params) | {k for k, _ in spec.defaults}
    for k, v in overrides.items():
        if k in accepted and v is not None:
            kwargs[k] = v
    return AMRNumerics(mode=mode, **kwargs)
