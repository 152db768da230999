"""Tree helpers over nested dicts/lists of tensors.

Leaves are visited in the order ``jax.tree_util`` uses — dict keys sorted,
lists and tuples by index, ``None`` is an empty subtree — and paths are the
reference's '/'-joined strings (``repro.utils.tree.path_str``), so ERK
budgets, archives and bitmaps are keyed and ordered identically in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

PyTree = Any


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_map_with_path(fn: Callable[..., Any], tree: PyTree, *rest: PyTree,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> PyTree:
    """Map ``fn(path, leaf, *rest_leaves)`` over ``tree``, keeping its
    structure; ``rest`` trees must share it."""

    def go(path, x, *xs):
        if is_leaf is not None and is_leaf(x):
            return fn(path, x, *xs)
        if isinstance(x, dict):
            return {k: go(_join(path, k), x[k], *(r[k] for r in xs))
                    for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            out = [go(_join(path, i), v, *(r[i] for r in xs))
                   for i, v in enumerate(x)]
            return out if isinstance(x, list) else tuple(out)
        if x is None:
            return None
        return fn(path, x, *xs)

    return go("", tree, *rest)


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest,
                              is_leaf=is_leaf)


def tree_leaves_with_path(tree: PyTree,
                          is_leaf: Optional[Callable[[Any], bool]] = None
                          ) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


def tree_leaves(tree: PyTree,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> list[Any]:
    return [x for _, x in tree_leaves_with_path(tree, is_leaf=is_leaf)]


def tree_unflatten_like(tree: PyTree, leaves) -> PyTree:
    """A tree shaped like ``tree`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_unzip(paired: PyTree) -> tuple[PyTree, PyTree]:
    """Split a tree whose leaves are pairs into two trees."""
    is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
    return (tree_map(lambda t: t[0], paired, is_leaf=is_pair),
            tree_map(lambda t: t[1], paired, is_leaf=is_pair))


def tree_size(tree: PyTree) -> int:
    """Total number of scalar elements."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_nnz(tree: PyTree) -> int:
    """Number of non-zero entries (for masks: active parameter count), read
    back from the device once."""
    leaves = tree_leaves(tree)
    if not leaves:
        return 0
    return int(torch.stack([(x != 0).sum() for x in leaves]).sum())


def tree_ones_like(tree: PyTree) -> PyTree:
    return tree_map(torch.ones_like, tree)


def tree_index(tree: PyTree, i) -> PyTree:
    """Index every leaf's leading dimension (a stacked tree's slot ``i``)."""
    return tree_map(lambda x: x[i], tree)
