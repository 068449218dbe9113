"""Nested dicts of tensors as trees: the port's stand-in for JAX's pytrees
of parameters, optimizer state and gradients. Leaves are visited in
sorted key order, recursively, which is the order in which
``jax.tree_util.tree_flatten`` flattens a dict, so a list of leaves means
the same thing in both packages (checkpoints rely on it)."""

from __future__ import annotations

from typing import Any


def leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s keys whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
