"""Nested dicts and lists of tensors, flattened as ``jax.tree_util`` does.

JAX flattens a dict in sorted key order and a list or tuple in its own
order; ``None`` holds no leaf. The compressors number leaves in that order
(state keys, warm-start Q, the order of the fused buffers), so the port
flattens the same way and names each leaf with the path that
``jax.tree_util.keystr`` gives it, e.g. ``['stage0'][0]['bn1']['bias']``.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

__all__ = [
    "Tree",
    "flatten_with_paths",
    "tree_leaves",
    "tree_unflatten",
    "tree_map",
]

Tree = Any


def _children(node: Tree) -> list[tuple[str, Tree]] | None:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in JAX flatten order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out += flatten_with_paths(child, prefix + key)
    return out


def tree_leaves(tree: Tree) -> list[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_unflatten(like: Tree, leaves: list[Any]) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it: Iterator[Any] = iter(leaves)

    def build(node: Tree) -> Tree:
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places for")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """``fn`` over the leaves of ``tree``, in a tree of the same shape."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])
