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

from repro_torch.utils.tree import tree_leaves_with_path, tree_map

PyTree = Any


def _bfloat16_numpy():
    """numpy's bfloat16 dtype (``ml_dtypes``, the type of the reference's
    bf16 leaves), or None where ``ml_dtypes`` is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def to_numpy(x) -> np.ndarray:
    """A tensor as a numpy array, bit for bit.  numpy has no bfloat16 of
    its own: a bf16 tensor leaves as its 16-bit patterns viewed as
    ``ml_dtypes.bfloat16``, the type the reference's bf16 arrays have."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype != torch.bfloat16:
        return x.numpy()
    bf16 = _bfloat16_numpy()
    if bf16 is None:
        raise TypeError("a bfloat16 tensor needs ml_dtypes to leave as a "
                        "numpy array (numpy has no bfloat16)")
    return x.view(torch.int16).numpy().view(bf16)


def _tensor(a, device) -> torch.Tensor:
    a, bf16 = np.asarray(a), _bfloat16_numpy()
    if bf16 is not None and a.dtype == bf16:
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def tree_from_numpy(tree: PyTree, device="cpu") -> PyTree:
    """A tree of numpy arrays (a reference tree, after ``np.asarray`` of
    its leaves) as a tree of tensors on ``device``, copied bit for bit;
    ``ml_dtypes.bfloat16`` leaves arrive as ``torch.bfloat16``."""
    return tree_map(lambda a: _tensor(a, device), tree)


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


def load_clients(dirpath: str, device="cpu") -> list[PyTree]:
    """The per-client trees ``save_clients`` (either package's) wrote to
    ``dirpath``, in client order, as tensors on ``device``."""
    files = sorted(f for f in os.listdir(dirpath) if f.endswith(".npz"))
    return [tree_from_numpy(load_pytree(os.path.join(dirpath, f)), device)
            for f in files]

