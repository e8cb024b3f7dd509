"""``tree_map`` and flattening over the port's parameter, cache and
training-state trees (dicts, tuples, dataclasses such as ``KVCache``,
``SSMState``, ``TrainState``, tensors at the leaves)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise to ``tree`` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                            for f in dataclasses.fields(tree)))
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's flatten order: dict keys
    sorted, tuple entries and dataclass fields in order; a path joins dict
    keys, tuple indices and field names with "/" (``params/layers/0/attn/wq``),
    as the JAX package's checkpoint keys do."""
    def child(name) -> str:
        return f"{prefix}/{name}" if prefix else str(name)

    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in tree_items(tree[k], child(k))]
    if isinstance(tree, tuple):
        return [it for i, v in enumerate(tree) for it in tree_items(v, child(i))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [it for f in dataclasses.fields(tree)
                for it in tree_items(getattr(tree, f.name), child(f.name))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in ``tree_items`` order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure whose leaves, in ``tree_items`` order,
    are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return type(node)(*(build(getattr(node, f.name)) for f in dataclasses.fields(node)))
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
