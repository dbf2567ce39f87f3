"""Helpers over the port's parameter trees (nested dicts of tensors).

Counterpart of ``repro.utils.pytree`` for what the port needs so far.
Leaves are visited in the order ``jax.tree.leaves`` visits a dict
(sorted keys), so sums over leaves add in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


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


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``tree_leaves`` order, paths ``/``-joined as
    the reference's ``path_str`` names them (``blocks/sub0/moe/wo``)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k],
                                     f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


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


def tree_size(tree) -> int:
    """Total number of scalar parameters."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_average(trees):
    """Element-wise average of identically-structured trees: the FedAvg /
    proxy-model operator (paper Fig. 4 and Eq. 13).  Summed in f32 in
    list order, divided, cast back to each leaf's dtype; one tree is
    returned as it is."""
    n = len(trees)
    if n == 0:
        raise ValueError("tree_average of empty list")
    if n == 1:
        return trees[0]

    def avg(*xs):
        acc = xs[0].to(torch.float32, copy=True)
        for x in xs[1:]:
            acc += x.float()
        return (acc / n).to(xs[0].dtype)

    return tree_map(avg, *trees)
