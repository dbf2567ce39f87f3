"""Helpers over the port's parameter trees (nested dicts of tensors).

Counterpart of ``repro.utils.pytree`` for what the port needs so far.
Leaves are visited in the order ``jax.tree.leaves`` visits a dict
(sorted keys), so sums over leaves add in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves: List[Any]) -> Dict[str, Any]:
    """A tree of ``tree``'s structure holding ``leaves`` (in the order of
    ``tree_leaves``)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def tree_bytes(tree) -> int:
    """Total bytes, each leaf at its own dtype.  Works on meta tensors,
    so a 1.1B configuration's size costs no allocation."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
