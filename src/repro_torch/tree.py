"""Nested containers of tensors in JAX's pytree leaf order: dict keys
sorted at every level, tuple and list items in order, ``None`` no leaf.
The optimizers walk their state in this order, and the checkpointer
numbers its leaves by it, so that a checkpoint of either package
restores in the other."""
from __future__ import annotations

from typing import Any, List

__all__ = ["leaves", "unflatten", "flatten_up_to"]


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    if tree is None:
        return []
    return [tree]


def unflatten(like, new_leaves):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        return next(it)
    return build(like)


def flatten_up_to(like, tree) -> List[Any]:
    """``tree``'s subtrees at the leaf positions of the nested dict
    ``like`` (JAX's ``flatten_up_to``): an optimizer state's per-leaf
    dicts, in ``like``'s leaf order."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in flatten_up_to(like[k], tree[k])]
    return [tree]
