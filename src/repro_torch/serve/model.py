"""Model adapters the serving engine is generic over (reference
``repro.serve.model``).

The engine needs three things from a model: a base ``init``, a per-request
input builder (seed-derived, so runs are reproducible), and a *batched*
forward that scores U user models against U inputs in one launch per
layer.  Only ``MLPModel`` is ported; the reference's ``TaskModel`` (conv
CNNs) and ``ArchModel`` (smoke LM archs) are not yet.

Params are plain nested dicts of tensors, ``{"layer<i>": {"w": (d_i,
d_{i+1})}}``, keyed as the reference's.  A reference tree (numpy leaves,
``np.asarray`` of its jax arrays) becomes a port tree through
``repro_torch.checkpoint.npz.tree_from_numpy``, bit for bit — that is how
the tests serve the same models from both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.masked_matmul import (
    batched_masked_matmul,
    batched_masked_matmul_plain,
)

PyTree = Any

BACKENDS = ("vmap", "ref", "kernel")


class MLPModel:
    """Bias-free relu MLP: every layer is ``h @ (w ⊙ m)`` — the matmul
    pipeline the batched kernel serves.  ``rows`` is the number of input
    rows per request (M of the matmul).

    Backends of ``batched_forward``:

    - ``vmap``   — ``torch.func.vmap`` of ``forward`` over the pool's
      dense-masked params (the store's params are already ``w ⊙ m``).  On
      the CPU at ``rows >= 2`` it is bit-equal to the per-user loop (at one
      row the per-user matmul becomes a matrix-vector product, which sums
      in another order).
    - ``ref``    — the plain batched masked matmul, one call per layer.
    - ``kernel`` — ``kernels.masked_matmul.batched_masked_matmul``, one
      launch of the CUDA kernel per layer on CUDA tensors (the reference's
      ``pallas`` backend); on CPU tensors its plain version runs.
    """

    def __init__(self, d_in: int = 64, widths: tuple[int, ...] = (128, 128),
                 n_out: int = 32, rows: int = 4):
        self.d_in = int(d_in)
        self.dims = (self.d_in, *[int(w) for w in widths], int(n_out))
        self.rows = int(rows)
        self._keys = [f"layer{i}" for i in range(len(self.dims) - 1)]

    def init(self, gen: torch.Generator, device="cpu") -> PyTree:
        """Lecun-normal weights drawn from ``gen`` (on the generator's
        device), then moved to ``device``."""
        params = {}
        for i, name in enumerate(self._keys):
            w = torch.randn((self.dims[i], self.dims[i + 1]), generator=gen,
                            dtype=torch.float32, device=gen.device)
            params[name] = {"w": (w / np.sqrt(self.dims[i])).to(device)}
        return params

    def make_input(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x1]))
        return rng.standard_normal((self.rows, self.d_in)).astype(np.float32)

    def forward(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """Single-user forward over dense(-masked) params — the oracle the
        batched backends are checked against."""
        h = x
        for i, name in enumerate(self._keys):
            h = h @ params[name]["w"]
            if i < len(self._keys) - 1:
                h = torch.relu(h)
        return h

    def batched_forward(self, params_stack: PyTree, masks_stack: PyTree,
                        xs: torch.Tensor, backend: str = "vmap"
                        ) -> torch.Tensor:
        """xs: (U, rows, d_in) -> (U, rows, n_out); one launch per layer."""
        if backend == "vmap":
            return torch.func.vmap(self.forward)(params_stack, xs)
        if backend == "ref":
            bmm = batched_masked_matmul_plain
        elif backend == "kernel":
            bmm = batched_masked_matmul
        else:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")
        h = xs
        for i, name in enumerate(self._keys):
            h = bmm(h, params_stack[name]["w"], masks_stack[name]["w"])
            if i < len(self._keys) - 1:
                h = torch.relu(h)
        return h

    def backends(self) -> tuple[str, ...]:
        return BACKENDS
