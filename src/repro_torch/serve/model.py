"""Model adapters the serving engine is generic over (reference
``repro.serve.model``).

The engine needs three things from a model: a base ``init`` (from a
``torch.Generator``), a per-request input builder (seed-derived, so runs
are reproducible; the reference's numpy draws exactly), and a *batched*
forward that scores U user models against U inputs in one pool-wide call.
Three adapters cover the repo's model families, as in the reference:

* ``MLPModel`` — the masked-matmul pipeline, three backends (below).
* ``TaskModel`` — an FL ``Task``'s CNN (the backbones training archives
  come from); request = one image batch, response = class logits.
* ``ArchModel`` — a registered LM config (``configs.SMOKE_ARCHS`` from the
  CLI, or a full ``configs.ARCHS`` entry) as a one-step scorer: prefill a
  prompt, return the last position's logits.

``TaskModel`` and ``ArchModel`` have no masked-matmul pipeline: only the
``vmap`` backend (``torch.func.vmap`` of the per-user forward) applies, and
any other raises ``ValueError``.

Every pool-wide forward is compiled as the reference jits it: through
``utils.graph.graphed``, built at first use (``MLPModel`` one per backend),
so on the card it is a CUDA graph captured by the engine's ``warmup()``
and replayed for every batch (eager on CPU tensors and under
``graph.disabled()``).  The pool's params and masks are donated: a
capture reads its store's pool in place, never copies it, and is keyed by
that pool, so one model serves any number of stores of the same shapes,
each store's ``warmup()`` taking a capture of its own (on the card, a
pool no capture holds raises ``ValueError`` outside a warm-up); the
request inputs are copied into the capture's own buffer.  Until
``release()`` each capture keeps its store's pool alive, and a model's
captures share one memory pool (the forward's activations).  ``graphs()``
lists a model's compiled forwards (captures, replays, ``capture_s``,
``pool_bytes()``, ``release()``).

Params are plain nested dicts of tensors keyed as the reference's.  A
reference tree (numpy leaves, ``np.asarray`` of its jax arrays) becomes a
port tree through ``repro_torch.checkpoint.npz.tree_from_numpy``, bit for
bit — that is how the tests serve the same models from both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.masked_matmul import (
    batched_masked_matmul,
    batched_masked_matmul_plain,
)
from repro_torch.models import bind
from repro_torch.utils.graph import Graphed, graphed

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
        self._jfwd: dict[str, Graphed] = {}

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

    def _build(self, backend: str) -> Graphed:
        """The compiled pool-wide forward ``fwd(ps, ms, xs)`` of one
        backend."""
        if backend == "vmap":
            def fwd(ps, ms, xs):
                del ms  # params are already w ⊙ m
                return torch.func.vmap(self.forward)(ps, xs)
            return graphed(fwd, donate=(0, 1))
        if backend == "ref":
            bmm = batched_masked_matmul_plain
        elif backend == "kernel":
            bmm = batched_masked_matmul
        else:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")

        def fwd(ps, ms, xs):
            h = xs
            for i, name in enumerate(self._keys):
                h = bmm(h, ps[name]["w"], ms[name]["w"])
                if i < len(self._keys) - 1:
                    h = torch.relu(h)
            return h
        return graphed(fwd, donate=(0, 1))

    def batched_forward(self, params_stack: PyTree, masks_stack: PyTree,
                        xs: torch.Tensor, backend: str = "vmap"
                        ) -> torch.Tensor:
        """xs: (U, rows, d_in) -> (U, rows, n_out); one launch per layer."""
        if backend not in self._jfwd:
            self._jfwd[backend] = self._build(backend)
        return self._jfwd[backend](params_stack, masks_stack, xs)

    def graphs(self) -> list[Graphed]:
        return list(self._jfwd.values())

    def backends(self) -> tuple[str, ...]:
        return BACKENDS


def _vmap_only(name: str, backend: str) -> None:
    if backend != "vmap":
        raise ValueError(
            f"{name} has no masked-matmul pipeline; only the vmap backend "
            f"applies, got {backend}")


class _VmapForward:
    """The vmap-only families' compiled pool-wide forward: ``forward``
    vmapped over the users, built at first use."""

    _jfwd: Graphed | None = None

    def batched_forward(self, params_stack: PyTree, masks_stack: PyTree,
                        xs: torch.Tensor, backend: str = "vmap"
                        ) -> torch.Tensor:
        del masks_stack  # params are already w ⊙ m
        _vmap_only(self._name(), backend)
        if self._jfwd is None:
            self._jfwd = graphed(torch.func.vmap(self.forward), donate=(0,))
        return self._jfwd(params_stack, xs)

    def graphs(self) -> list[Graphed]:
        return [] if self._jfwd is None else [self._jfwd]

    def backends(self) -> tuple[str, ...]:
        return ("vmap",)


class TaskModel(_VmapForward):
    """Serve an FL ``Task``'s model family (conv CNNs): request = one image
    batch ``(rows, hw, hw, in_ch)``, response = class logits.  vmap
    backend only."""

    def __init__(self, task, hw: int = 16, in_ch: int = 3, rows: int = 1):
        self.task = task
        self.hw = int(hw)
        self.in_ch = int(in_ch)
        self.rows = int(rows)

    def init(self, gen: torch.Generator) -> PyTree:
        """The task's init (params on the task's device)."""
        return self.task.init_fn(gen)

    def make_input(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x2]))
        return rng.standard_normal(
            (self.rows, self.hw, self.hw, self.in_ch)).astype(np.float32)

    def forward(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        return self.task.apply_fn(params, x)

    def _name(self) -> str:
        return f"TaskModel ({self.task.name})"


class ArchModel(_VmapForward):
    """Serve a registered LM config as a one-step scorer: prefill
    ``prompt_len`` tokens (``rows`` prompts per request), return the last
    position's logits ``(rows, vocab)``.  VLMs get a zero patch prefix of
    ``prefix_len``, enc-dec models zero frames of length 8, as in the
    reference.  vmap backend only."""

    def __init__(self, cfg, prompt_len: int = 8, rows: int = 1):
        self.cfg = cfg
        self.api = bind(cfg, remat=False)
        self.prompt_len = int(prompt_len)
        self.rows = int(rows)

    def init(self, gen: torch.Generator) -> PyTree:
        """Float32 params on the generator's device."""
        return self.api.init(gen)

    def make_input(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x3]))
        return rng.integers(0, self.cfg.vocab,
                            size=(self.rows, self.prompt_len),
                            dtype=np.int32)

    def forward(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        dev = tokens.device
        batch = {"tokens": tokens}
        kw = {}
        max_len = s + self.cfg.prefix_len    # prefix rides in the kv cache
        if self.cfg.prefix_len:
            batch["prefix"] = torch.zeros(
                (b, self.cfg.prefix_len, self.cfg.d_model), device=dev)
        if self.cfg.enc_layers:
            batch["frames"] = torch.zeros((b, 8, self.cfg.d_model), device=dev)
            kw["enc_len"] = 8
        cache = self.api.init_cache(b, max_len, device=dev, **kw)
        logits, _ = self.api.prefill(params, batch, cache)
        return logits[:, -1, :]

    def _name(self) -> str:
        return f"ArchModel ({self.cfg.name})"
