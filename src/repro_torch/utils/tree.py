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


def _map(fn, is_leaf, path, x, xs):
    if is_leaf is not None and is_leaf(x):
        return fn(path, x, *xs)
    if isinstance(x, dict):
        return {k: _map(fn, is_leaf, _join(path, k), x[k],
                        [r[k] for r in xs])
                for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        out = [_map(fn, is_leaf, _join(path, i), v, [r[i] for r in xs])
               for i, v in enumerate(x)]
        return out if isinstance(x, list) else tuple(out)
    if x is None:
        return None
    return fn(path, x, *xs)


def tree_map_with_path(fn: Callable[..., Any], tree: PyTree, *rest: PyTree,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> PyTree:
    """Map ``fn(path, leaf, *rest_leaves)`` over ``tree``, keeping its
    structure; ``rest`` trees must share it.  The recursion is a module
    function, not a closure over itself: a self-referencing closure is a
    reference cycle, which would keep ``fn`` — and whatever it holds, such
    as the leaves ``tree_leaves`` collects — alive until Python's cyclic
    collector runs (at full width, a whole stacked model)."""
    return _map(fn, is_leaf, "", tree, rest)


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
    return tree_nnz_each([tree])[0] if tree_leaves(tree) else 0


def tree_nnz_each(trees: list[PyTree]) -> list[int]:
    """``tree_nnz`` of every tree of ``trees``, read back once for all."""
    counts = torch.stack([torch.stack([(x != 0).sum()
                                       for x in tree_leaves(t)]).sum()
                          for t in trees])
    return [int(c) for c in counts.tolist()]


def tree_ones_like(tree: PyTree) -> PyTree:
    return tree_map(torch.ones_like, tree)


def tree_index(tree: PyTree, i) -> PyTree:
    """Index every leaf's leading dimension (a stacked tree's slot ``i``)."""
    return tree_map(lambda x: x[i], tree)


def tree_stack(trees: list[PyTree]) -> PyTree:
    """Same-structure trees -> one tree whose leaves gain a leading K dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree: PyTree, k: int) -> list[PyTree]:
    """Inverse of ``tree_stack``: the first K trees of slot views
    (contiguous, sharing the stacked tensors' storage).  Each leaf is
    unbound once, so under autograd the backward stacks the slots'
    gradients into one tensor (indexing slot by slot makes a full-size zero
    gradient per slot)."""
    parts = tree_map(lambda x: x.unbind(0), tree)
    is_parts = lambda t: isinstance(t, tuple)  # noqa: E731
    return [tree_map(lambda t: t[i], parts, is_leaf=is_parts)
            for i in range(k)]
