"""Tree helpers over nested dicts/lists of tensors.

Leaves are visited in the order ``jax.tree_util`` uses — dict keys sorted,
lists and tuples by index, ``None`` is an empty subtree — and paths are the
reference's '/'-joined strings (``repro.utils.tree.path_str``), so ERK
budgets, archives and bitmaps are keyed and ordered identically in both
packages.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Optional

import torch

PyTree = Any


def path_str(path) -> str:
    """Render a key path as 'a/b/0/c': its keys (strings, indices, or the
    reference's jax key entries, which carry ``key`` or ``idx``) joined by
    '/'.  The port's tree functions already hand out such strings."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


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


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of the leaves' elements."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_ones_like(tree: PyTree) -> PyTree:
    return tree_map(torch.ones_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_mul(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.mul, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Sum over the leaves of each leaf pair's dot product (0-d, on the
    leaves' device)."""
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_l2(a: PyTree) -> torch.Tensor:
    """The L2 norm of all the leaves' elements together (0-d)."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(a)))


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def split_like(gen: torch.Generator, tree: PyTree) -> PyTree:
    """One ``torch.Generator`` per leaf (on ``gen``'s device), same
    structure as ``tree``, each seeded by a draw from ``gen`` in leaf
    order (the reference splits a jax key; its draws cannot be
    replayed)."""
    seeds = torch.randint(0, 2 ** 62, (len(tree_leaves(tree)),),
                          generator=gen, device=gen.device).tolist()
    return tree_unflatten_like(tree, [
        torch.Generator(device=gen.device).manual_seed(s) for s in seeds])


def select_by_path(tree: PyTree, pattern: str) -> PyTree:
    """Boolean tree: True where the leaf's path matches regex
    ``pattern``."""
    rx = re.compile(pattern)
    return tree_map_with_path(lambda p, x: bool(rx.search(p)), tree)


def count_params(tree: PyTree) -> dict[str, int]:
    """Per-path parameter counts plus 'TOTAL'."""
    out = {p: x.numel() for p, x in tree_leaves_with_path(tree)}
    out["TOTAL"] = sum(out.values())
    return out


def check_finite(tree: PyTree) -> bool:
    """Whether every floating leaf holds only finite values (one read
    back)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if x.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


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
