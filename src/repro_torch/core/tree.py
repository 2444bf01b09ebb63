"""Nested payloads: the few pytree operations the router and engine use.

A tree is a dict (children in sorted key order, as JAX flattens it), a
tuple, a list, ``None`` (no leaves), or a leaf (a tensor or anything
else).  This stands in for ``jax.tree`` so that a routed message may
carry several fields through one bucket plan, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` inverts
    it."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append((d, len(sub)))
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for child in tree:
            sub, d = tree_flatten(child)
            leaves += sub
            defs.append((d, len(sub)))
        return leaves, (type(tree).__name__, None, tuple(defs))
    return [tree], "leaf"


def tree_unflatten(treedef, leaves):
    leaves = list(leaves)
    if treedef is None:
        return None
    if treedef == "leaf":
        (leaf,) = leaves
        return leaf
    kind, keys, defs = treedef
    children, at = [], 0
    for d, count in defs:
        children.append(tree_unflatten(d, leaves[at:at + count]))
        at += count
    if kind == "dict":
        return dict(zip(keys, children))
    return tuple(children) if kind == "tuple" else children


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which must have
    the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError("trees of different structure")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
