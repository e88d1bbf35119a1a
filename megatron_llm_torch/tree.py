"""Nested dicts of tensors (the port's param, grad and optimizer-state
trees; the JAX package uses pytrees).  Leaves are visited in sorted key
order, as ``jax.tree_util`` visits dict keys."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves_with_path(tree, prefix: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(key path, leaf)] in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` holding ``leaves`` (in the order of
    ``tree_leaves(like)``)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
