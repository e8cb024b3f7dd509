"""``tree_map`` over the port's parameter and cache trees (dicts, tuples,
cache dataclasses such as ``KVCache`` and ``SSMState``, tensors at the
leaves)."""
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
