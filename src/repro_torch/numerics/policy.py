"""Site-resolved numerics policies: one model, many multipliers.

The port of the JAX package's ``numerics/policy.py``.

  * :class:`NumericsPolicy` — the resolver protocol: anything with
    ``resolve(site, layer) -> AMRNumerics`` and ``policies()`` can sit in
    ``ModelConfig.numerics``.
  * :class:`UniformPolicy` — one ``AMRNumerics`` everywhere; it resolves
    to the same object at every site, so it computes what the bare
    ``AMRNumerics`` does.
  * :class:`PerLayerPolicy` — keyed on the flat layer index (the model's
    layer order) and the call-site label (``"mlp.w_gate"``, ``"attn.qk"``,
    ...).  Precedence: ``(layer, site) > layer > site > default``; site keys
    match by dotted prefix.

The model's sites resolve with ``resolve_numerics(numerics, site)``
(defined beside ``approx_matmul``, which resolves through it too) against
the ambient ``numerics_scope``'s ``static_layer``, which the model sets
around each layer.

Policies serialize to JSON (``save_policy`` / ``load_policy``) in the JAX
package's schema, and a file written by either package loads in the other.
The JAX package's ``AMRNumerics`` also has ``inject_impl`` (the device
picks the route here): the reader accepts that field and ignores it, and
the writer writes only fields the JAX reader accepts.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Protocol, runtime_checkable

from . import registry
from .approx_matmul import AMRNumerics, resolve_numerics

__all__ = ["NumericsPolicy", "UniformPolicy", "PerLayerPolicy", "as_policy", "resolve_numerics",
           "numerics_to_json", "numerics_from_json", "policy_to_json", "policy_from_json",
           "save_policy", "load_policy", "policy_summary"]


@runtime_checkable
class NumericsPolicy(Protocol):
    """Resolver protocol: ``ModelConfig.numerics`` may hold any of these."""

    def resolve(self, site: str | None = None, layer: int | None = None) -> AMRNumerics:
        """The multiplier design for one call site; ``layer`` is the flat
        layer index, or None outside the decoder's layers."""
        ...

    def policies(self) -> tuple[AMRNumerics, ...]:
        """Every distinct ``AMRNumerics`` this policy can resolve to."""
        ...


@dataclasses.dataclass(frozen=True)
class UniformPolicy:
    """One design point everywhere."""

    numerics: AMRNumerics = AMRNumerics("exact")

    def resolve(self, site: str | None = None, layer: int | None = None) -> AMRNumerics:
        return self.numerics

    def policies(self) -> tuple[AMRNumerics, ...]:
        return (self.numerics,)

    def is_exact(self) -> bool:
        return self.numerics.is_exact()


def _as_items(m, n_keys: int) -> tuple:
    """dict | iterable of tuples -> canonical sorted tuple of tuples."""
    if m is None:
        return ()
    items = m.items() if isinstance(m, dict) else m
    out = []
    for it in items:
        it = tuple(it)
        if len(it) == 2 and n_keys == 2 and isinstance(it[0], tuple):
            it = (*it[0], it[1])  # {(layer, site): nm} dict form
        if len(it) != n_keys + 1:
            raise ValueError(f"malformed policy entry {it!r}")
        out.append(it)
    return tuple(sorted(out, key=lambda t: tuple(map(str, t[:-1]))))


@dataclasses.dataclass(frozen=True)
class PerLayerPolicy:
    """Heterogeneous assignment keyed on the scope's coordinates.

    ``layers`` maps flat layer indices, ``sites`` call-site labels,
    ``layer_sites`` one site inside one layer; dicts are accepted and
    kept as sorted tuples (the policy stays hashable).  Precedence:
    ``(layer, site)`` > ``layer`` > ``site`` > ``default``.  Calls outside
    the decoder's layers resolve with ``layer=None``.  Site keys match by
    dotted prefix: ``"mlp"`` covers ``"mlp.w_up"`` unless a longer entry
    exists, within each precedence level.
    """

    default: AMRNumerics = AMRNumerics("exact")
    layers: Any = ()       # ((layer, AMRNumerics), ...)
    sites: Any = ()        # ((site, AMRNumerics), ...)
    layer_sites: Any = ()  # ((layer, site, AMRNumerics), ...)

    def __post_init__(self):
        object.__setattr__(self, "layers", _as_items(self.layers, 1))
        object.__setattr__(self, "sites", _as_items(self.sites, 1))
        object.__setattr__(self, "layer_sites", _as_items(self.layer_sites, 2))
        for nm in self.policies():
            if not isinstance(nm, AMRNumerics):
                raise ValueError(f"PerLayerPolicy entries must be AMRNumerics, got {nm!r}")
            registry.validate_policy(nm)
        for layer, _ in self.layers:
            if not isinstance(layer, int):
                raise ValueError(f"layer keys must be int, got {layer!r}")
        for layer, site, _ in self.layer_sites:
            if not isinstance(layer, int) or not isinstance(site, str):
                raise ValueError(f"layer_sites keys must be (int, str), got {(layer, site)!r}")
        # lookup maps, derived from the canonical tuples
        object.__setattr__(self, "_layer_map", dict(self.layers))
        object.__setattr__(self, "_site_map", dict(self.sites))
        object.__setattr__(self, "_layer_site_map",
                           {(layer, site): nm for layer, site, nm in self.layer_sites})

    @staticmethod
    def _site_lookup(m: dict, key, site: str):
        """The exact site first, then the longest dotted prefix."""
        while True:
            nm = m.get(key(site))
            if nm is not None or "." not in site:
                return nm
            site = site.rsplit(".", 1)[0]

    def resolve(self, site: str | None = None, layer: int | None = None) -> AMRNumerics:
        if layer is not None:
            layer = int(layer)
            if site is not None:
                nm = self._site_lookup(self._layer_site_map, lambda s: (layer, s), site)
                if nm is not None:
                    return nm
            nm = self._layer_map.get(layer)
            if nm is not None:
                return nm
        if site is not None:
            nm = self._site_lookup(self._site_map, lambda s: s, site)
            if nm is not None:
                return nm
        return self.default

    def policies(self) -> tuple[AMRNumerics, ...]:
        seen: list[AMRNumerics] = [self.default]
        for nm in ([nm for _, nm in self.layers] + [nm for _, nm in self.sites]
                   + [nm for _, _, nm in self.layer_sites]):
            if nm not in seen:
                seen.append(nm)
        return tuple(seen)

    def is_exact(self) -> bool:
        return all(nm.is_exact() for nm in self.policies())


def as_policy(numerics) -> NumericsPolicy | None:
    """Wrap a bare ``AMRNumerics`` as a :class:`UniformPolicy`; None and
    policies pass through."""
    if numerics is None or isinstance(numerics, (UniformPolicy, PerLayerPolicy)):
        return numerics
    if isinstance(numerics, AMRNumerics):
        return UniformPolicy(numerics)
    if hasattr(numerics, "resolve"):
        return numerics
    raise TypeError(f"not a numerics policy: {numerics!r}")


# ------------------------------------------------------------------ JSON
# Schema (the JAX package's):
#   numerics:  {"mode": str, "border": int, "rank": int, "noise_seed": int,
#               "schedule_ref": str|null}  (the JAX writer adds "inject_impl")
#   uniform:   {"kind": "uniform", "numerics": {...}}
#   per_layer: {"kind": "per_layer", "default": {...},
#               "layers": {"<flat index>": {...}}, "sites": {"<site>": {...}},
#               "layer_sites": [[layer, site, {...}], ...], "meta": {...}}

_NUMERICS_FIELDS = ("mode", "border", "rank", "noise_seed", "schedule_ref")
_IGNORED_FIELDS = ("inject_impl",)  # a JAX-only field, read and dropped


def numerics_to_json(nm: AMRNumerics) -> dict:
    return {f: getattr(nm, f) for f in _NUMERICS_FIELDS}


def numerics_from_json(d: dict) -> AMRNumerics:
    unknown = set(d) - set(_NUMERICS_FIELDS) - set(_IGNORED_FIELDS)
    if unknown:
        raise ValueError(f"unknown AMRNumerics fields in policy JSON: {sorted(unknown)}; "
                         f"valid fields: {_NUMERICS_FIELDS + _IGNORED_FIELDS}")
    return AMRNumerics(**{k: v for k, v in d.items() if k in _NUMERICS_FIELDS})


def policy_to_json(policy) -> dict:
    policy = as_policy(policy)
    if isinstance(policy, UniformPolicy):
        return {"kind": "uniform", "numerics": numerics_to_json(policy.numerics)}
    if isinstance(policy, PerLayerPolicy):
        return {
            "kind": "per_layer",
            "default": numerics_to_json(policy.default),
            "layers": {str(k): numerics_to_json(v) for k, v in policy.layers},
            "sites": {s: numerics_to_json(v) for s, v in policy.sites},
            "layer_sites": [[k, s, numerics_to_json(v)] for k, s, v in policy.layer_sites],
        }
    raise TypeError(f"cannot serialize policy of type {type(policy).__name__}")


def policy_from_json(obj: dict) -> NumericsPolicy:
    kind = obj.get("kind")
    if kind == "uniform":
        return UniformPolicy(numerics_from_json(obj["numerics"]))
    if kind == "per_layer":
        return PerLayerPolicy(
            default=numerics_from_json(obj.get("default", {"mode": "exact"})),
            layers=tuple((int(k), numerics_from_json(v))
                         for k, v in obj.get("layers", {}).items()),
            sites=tuple((s, numerics_from_json(v)) for s, v in obj.get("sites", {}).items()),
            layer_sites=tuple((int(k), s, numerics_from_json(v))
                              for k, s, v in obj.get("layer_sites", [])))
    raise ValueError(f"unknown policy kind {kind!r}; expected 'uniform' or 'per_layer'")


def save_policy(policy, path, *, meta: dict | None = None) -> None:
    """Write the policy's JSON to ``path`` (tmp + rename: a reader never
    sees a torn file)."""
    obj = policy_to_json(policy)
    if meta:
        obj["meta"] = meta
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_policy(path) -> NumericsPolicy:
    """Load a policy JSON file.  ``schedule_ref`` handles must already be
    registered in this process (``injection.register_schedule``)."""
    with open(path) as f:
        return policy_from_json(json.load(f))


def policy_summary(policy) -> str:
    """Short label of a heterogeneous policy, e.g.
    ``perlayer[3l+1s: exact; kernel b8]``."""
    policy = as_policy(policy)
    if policy is None or isinstance(policy, UniformPolicy):
        raise ValueError("policy_summary is for heterogeneous policies")
    modes: dict[str, list[int]] = {}
    for nm in policy.policies():
        modes.setdefault(nm.mode, []).append(nm.border)
    parts = []
    for mode, borders in modes.items():
        if registry.is_exact_mode(mode):
            parts.append(mode)
            continue
        lo, hi = min(borders), max(borders)
        parts.append(f"{mode.removeprefix('amr_')} b{lo}" + (f"-b{hi}" if hi != lo else ""))
    n_l = len(policy.layers) + len({k for k, _, _ in policy.layer_sites})
    n_s = len(policy.sites)
    cov = f"{n_l}l" + (f"+{n_s}s" if n_s else "")
    return f"perlayer[{cov}: {'; '.join(parts)}]"
