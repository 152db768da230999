"""Local mask search (paper Alg. 2, Fig. 1c) — RigL-style prune & regrow
(reference ``repro.core.evolve``).

Once per round each client takes the dense gradient on one batch, then per
layer prunes the alpha_t-fraction of active weights with the smallest
magnitude and regrows as many among the coordinates inactive in the pruned
mask, by largest gradient magnitude.  Counts are exact: selection is a
stable argsort, so ties go to the lowest index, as ``jnp.argsort`` does.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.core.masks import default_sparsifiable
from repro_torch.utils.tree import (
    tree_leaves_with_path,
    tree_map_with_path,
    tree_unzip,
)

PyTree = Any


def cosine_prune_rate(alpha0: float, round_idx: int, total_rounds: int) -> float:
    """alpha_t = alpha_0/2 * (1 + cos(t*pi/T))."""
    t = min(round_idx, total_rounds)
    return alpha0 / 2.0 * (1.0 + math.cos(t * math.pi / max(total_rounds, 1)))


def _exact_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """{0,1} mask (flattened) selecting the k largest scores, exact count
    under ties (lowest index first)."""
    flat = scores.reshape(-1)
    if k <= 0:
        return torch.zeros_like(flat)
    order = torch.argsort(-flat, stable=True)
    sel = torch.zeros_like(flat)
    sel[order[:k]] = 1.0
    return sel


def evolve_mask_layer(w: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                      prune_rate: float, n_active: int):
    """One layer of Alg. 2.  Returns (new_mask, new_weights); the budget
    n_active is kept exactly: prune n_prune, regrow n_prune."""
    n_prune = int(math.ceil(prune_rate * n_active))
    n_keep = n_active - n_prune
    shape = w.shape
    mf = m.reshape(-1).float()
    wf = w.reshape(-1).float()
    gf = g.reshape(-1).float()
    neg_inf = torch.full((), float("-inf"), device=w.device)
    keep_scores = torch.where(mf > 0, wf.abs(), neg_inf)
    m_half = _exact_topk_mask(keep_scores, n_keep)
    # regrow among coordinates inactive in the *pruned* mask, so a coordinate
    # pruned this round may come straight back
    grow_scores = torch.where(m_half > 0, neg_inf, gf.abs())
    grown = _exact_topk_mask(grow_scores, n_prune)
    new_m = (m_half + grown).reshape(shape)
    new_w = w * new_m.to(w.dtype)
    return new_m.to(m.dtype), new_w


def evolve_masks(
    params: PyTree,
    mask: PyTree,
    dense_grads: PyTree,
    prune_rate: float,
    layer_nnz: dict[str, int],
    sparsifiable: Callable[[str, Any], bool] = default_sparsifiable,
):
    """Apply Alg. 2 across the tree; returns (new_mask, new_params).
    Leaves without a budget pass through unchanged."""

    def one(path, w, m, g):
        if path in layer_nnz and sparsifiable(path, w):
            return evolve_mask_layer(w, m, g, prune_rate, layer_nnz[path])
        return m, w

    return tree_unzip(tree_map_with_path(one, params, mask, dense_grads))


def layer_nnz_budgets(params: PyTree, densities: dict[str, float]) -> dict[str, int]:
    """Static per-layer active counts implied by ERK densities."""
    out = {}
    for p, x in tree_leaves_with_path(params):
        if p in densities:
            out[p] = int(round(densities[p] * x.numel()))
    return out
