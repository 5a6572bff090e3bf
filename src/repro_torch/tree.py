"""Nested dict/list trees of tensors, walked in JAX's flattening order.

``jax.tree.flatten`` visits dict keys in sorted order and list entries by
index; :func:`leaves` does the same (it is ``bridge.flatten_with_paths``
without the paths), so a flat gradient vector built here lays out its
leaves exactly as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from repro_torch.bridge import flatten_with_paths

Tree = Any
_END = object()


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Tree, new_leaves) -> Tree:
    """``like``'s structure with its leaves replaced, in :func:`leaves` order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(node: Tree, it: Iterator) -> Tree:
    if isinstance(node, dict):
        rebuilt = {k: _rebuild(node[k], it) for k in sorted(node)}
        return {k: rebuilt[k] for k in node}  # keep the caller's key order
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has") from None


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])
