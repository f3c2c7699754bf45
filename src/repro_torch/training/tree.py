"""Leaf order of parameter and optimizer trees, as ``jax.tree.flatten``
orders them: dict keys sorted, lists and tuples in order, ``NamedTuple``
fields in order, ``None`` an empty subtree. ``optimizer.global_norm`` sums
its leaves in this order and a checkpoint stores them in it, so a port
checkpoint and a reference one hold the same leaves in the same places.
"""

from __future__ import annotations

from typing import Any, Callable, List

_END = object()


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure whose leaves, in :func:`leaves`
    order, are ``new_leaves`` (``treedef.unflatten``)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # the caller's key order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of ``tree``'s structure."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))])
