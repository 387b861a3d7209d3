"""Nested-dict trees of tensors: the port's counterpart of the
tree utilities the JAX package uses on its parameter pytrees.  Dict
keys are visited in sorted order, as JAX's tree utilities visit them."""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)
