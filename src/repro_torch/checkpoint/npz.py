"""Checkpointing: trees <-> .npz archives, the reference's on-disk format.

Leaves are stored flat under their '/'-joined paths and the nesting is
rebuilt from the paths on load (``repro.checkpoint.npz``), so an archive
written by either package loads into the other.  Tensors leave through
numpy; ``load_pytree`` returns numpy arrays and the caller decides the
device.  This is where reference weights and masks cross into the port.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_path

PyTree = Any


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: PyTree) -> None:
    flat = {p: to_numpy(x) for p, x in tree_leaves_with_path(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def _insert(root: dict, keys: list[str], value) -> None:
    cur = root
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value


def load_pytree(path: str) -> PyTree:
    """Nested dict of numpy arrays."""
    with np.load(path) as z:
        root: dict = {}
        for key in z.files:
            _insert(root, key.split("/"), z[key])
    return root


def save_clients(dirpath: str, states: list[dict]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for k, st in enumerate(states):
        save_pytree(os.path.join(dirpath, f"client_{k:04d}.npz"), st)

