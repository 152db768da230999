"""Personalized sparse masks — ERK allocation and mask initialization
(reference ``repro.core.masks``).

The ERK solve is numpy and is a line-for-line copy of the reference, so
per-layer densities (and the nnz budgets derived from them) are identical.
``init_mask`` draws Bernoulli masks from a ``torch.Generator``; it cannot
replay ``jax.random`` and does not try to — runs that must match the
reference start from a reference archive instead.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_path, tree_map, tree_map_with_path

PyTree = Any


def default_sparsifiable(path: str, leaf) -> bool:
    """Weights (ndim>=2) are sparsifiable; biases/norm scales are not."""
    del path
    return hasattr(leaf, "ndim") and leaf.ndim >= 2


def erk_layer_densities(
    shapes: dict[str, tuple[int, ...]],
    density: float,
    erk_power_scale: float = 1.0,
) -> dict[str, float]:
    """Solve per-layer ERK densities so that total nnz ~= density * total.

    raw_l = (sum(shape)/prod(shape))**power; density_l = min(1, eps*raw_l);
    eps solved by iteratively freezing saturated layers.
    """
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0,1], got {density}")
    numel = {k: int(np.prod(s)) for k, s in shapes.items()}
    total = sum(numel.values())
    target_nnz = density * total
    raw = {
        k: (float(np.sum(s)) / float(np.prod(s))) ** erk_power_scale
        for k, s in shapes.items()
    }
    dense_layers: set[str] = set()
    while True:
        dense_nnz = sum(numel[k] for k in dense_layers)
        free = {k: v for k, v in raw.items() if k not in dense_layers}
        denom = sum(raw[k] * numel[k] for k in free)
        if denom <= 0:
            eps = 0.0
        else:
            eps = (target_nnz - dense_nnz) / denom
        newly_dense = [k for k in free if raw[k] * eps > 1.0]
        if not newly_dense:
            break
        dense_layers.update(newly_dense)
    out = {}
    for k in shapes:
        if k in dense_layers:
            out[k] = 1.0
        else:
            out[k] = float(np.clip(raw[k] * eps, 0.0, 1.0))
    return out


def annealed_density(d0: float, d_final: float, t: int, t_end: int) -> float:
    """Cosine sparse-to-sparser density schedule (DA-DPFL, Long et al. 2024)."""
    if not 0.0 < d_final <= d0:
        raise ValueError(
            f"need 0 < d_final <= d0, got d_final={d_final}, d0={d0}")
    frac = 0.5 * (1.0 + math.cos(min(t, t_end) * math.pi / max(t_end, 1)))
    return d_final + (d0 - d_final) * frac


def erk_densities_for_params(
    params: PyTree,
    density: float,
    sparsifiable: Callable[[str, Any], bool] = default_sparsifiable,
) -> dict[str, float]:
    """ERK densities for the sparsifiable leaves of a parameter tree."""
    shapes = {
        p: tuple(x.shape)
        for p, x in tree_leaves_with_path(params)
        if sparsifiable(p, x)
    }
    if not shapes:
        return {}
    return erk_layer_densities(shapes, density)


def init_mask(
    gen: torch.Generator,
    params: PyTree,
    density: float,
    sparsifiable: Callable[[str, Any], bool] = default_sparsifiable,
) -> PyTree:
    """Random ERK mask for one client: Bernoulli(density_l) per layer,
    float32 on the params' device.  Non-sparsifiable leaves get all-ones.
    The draws are made on the generator's device in leaf order."""
    densities = erk_densities_for_params(params, density, sparsifiable)

    def one(path, x):
        if path in densities:
            u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                           device=gen.device)
            return (u < densities[path]).to(torch.float32).to(x.device)
        return torch.ones(x.shape, dtype=torch.float32, device=x.device)

    return tree_map_with_path(one, params)


def init_client_masks(
    gen: torch.Generator,
    params: PyTree,
    capacities: list[float],
    sparsifiable: Callable[[str, Any], bool] = default_sparsifiable,
    dtype=torch.float32,
) -> list[PyTree]:
    """Personalized masks m_{k,0}, one per client, density = capacity c_k,
    drawn from ``gen`` client after client."""
    return [tree_map(lambda m: m.to(dtype),
                     init_mask(gen, params, c, sparsifiable))
            for c in capacities]


def mask_density(
    mask: PyTree,
    params: PyTree | None = None,
    sparsifiable: Callable[[str, Any], bool] = default_sparsifiable,
) -> float:
    """Achieved density over sparsifiable leaves (one read back)."""
    ref = params if params is not None else mask
    flags = {p: sparsifiable(p, x) for p, x in tree_leaves_with_path(ref)}
    held = [m for p, m in tree_leaves_with_path(mask) if flags.get(p, True)]
    if not held:
        return 0.0
    nnz = int(torch.stack([(m != 0).sum() for m in held]).sum())
    return nnz / max(sum(m.numel() for m in held), 1)


def apply_mask(params: PyTree, mask: PyTree) -> PyTree:
    """w ⊙ m (Hadamard product over the tree)."""
    return tree_map(lambda w, m: w * m.to(w.dtype), params, mask)
