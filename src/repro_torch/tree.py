"""Trees of tensors: nested dicts (the model's parameter tree) and
NamedTuples (the optimizer's ``AdamState``), with the few walks the
training path needs.  Leaves come in one order everywhere, that of
``jax.tree.leaves`` in the JAX package: dict keys sorted, NamedTuple
fields in order.  The checkpoint's leaf names are the paths in that
order joined by dots."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _items(tree) -> Optional[list]:
    """(key, child) pairs of an inner node in leaf order; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return None


def leaves_with_paths(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)]: ``path`` is the tuple of keys from the root."""
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    return [leaf for k, v in items
            for leaf in leaves_with_paths(v, prefix + (k,))]


def leaves(tree) -> list:
    return [x for _, x in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    return fn(tree, *rest)


def map_with_paths(fn: Callable, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_paths(fn, v, prefix + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(prefix, tree)
