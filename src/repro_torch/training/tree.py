"""Nested dicts of tensors as the reference's pytrees.

``jax.tree.leaves`` visits a dict's entries in sorted key order; these
helpers walk the port's parameter and optimizer dicts in that same order,
so sums over leaves round as the reference's do and checkpoint keys are
the reference's paths joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable


def items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's leaf order; a path is the
    keys joined by ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure whose leaves are ``new_leaves``, given
    in ``leaves(tree)``'s order."""
    it = iter(new_leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        built = {k: build(t[k]) for k in sorted(t)}
        return {k: built[k] for k in t}

    return build(tree)
