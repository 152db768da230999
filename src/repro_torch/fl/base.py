"""Shared substrate for the strategies (reference ``repro.fl.base``).

A ``Task`` bundles a CNN backbone with its loss/grad/accuracy functions, the
per-layer analytic FLOPs map and the device everything runs on.
``local_sgd`` is the paper's local phase: E epochs of minibatch SGD (masked
when a mask is given) with batches padded to whole size, driven by a
per-client, per-round numpy generator (``fl.engine.derive_rng``) so batch
orders replay the reference's exactly; ``finetune_clients`` runs it from
each client's params for the -FT eval variants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import setup_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.common import softmax_xent
from repro_torch.optim.sgd import SGDConfig, init_sgd, masked_sgd_step, sgd_step
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

PyTree = Any


def init_generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a SeedSequence over ``words``: the
    strategies' initial draws (params, masks).  They cannot replay the
    reference's ``jax.random`` draws; a run that must match the reference
    restores a reference archive instead."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


@dataclasses.dataclass
class Task:
    name: str
    init_fn: Callable[[torch.Generator], PyTree]     # params on ``device``
    apply_fn: Callable[[PyTree, torch.Tensor], torch.Tensor]
    fwd_flops: dict[str, float]          # per-sample forward FLOPs per weight leaf
    n_classes: int
    device: torch.device

    def as_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def value_and_grad(self, params: PyTree, x, y):
        """(loss, grads) of the mean cross-entropy, grads keyed like params."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        logits = self.apply_fn(tree_unflatten_like(params, leaves),
                               self.as_tensor(x))
        loss = softmax_xent(logits, self.as_tensor(y))
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten_like(params, grads)

    @torch.no_grad()
    def accuracy(self, params: PyTree, x, y) -> float:
        pred = torch.argmax(self.apply_fn(params, self.as_tensor(x)), dim=-1)
        correct = (pred == self.as_tensor(y)).float().sum()
        # sum * (1/n) in fp32, the rounding of the reference's jitted mean
        # (XLA strength-reduces its divide-by-constant to a reciprocal multiply)
        return float(correct * (torch.tensor(1.0) / float(len(y))))

    @torch.no_grad()
    def accuracy_stacked(self, stacked_params: PyTree, x: torch.Tensor,
                         y: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """(K,) accuracies of K stacked models on (K, L, ...) padded test
        sets, over the rows ``live`` marks, in one vmapped call.  Per client
        ``sum(correct & live) * (1 / sum(live))``: 0/1 sums are exact in
        fp32, so each equals ``accuracy`` on the client's own rows."""

        def acc_one(p, xk, yk, lk):
            pred = torch.argmax(self.apply_fn(p, xk), dim=-1)
            correct = ((pred == yk) & lk).to(torch.float32).sum()
            n = lk.to(torch.float32).sum()
            return correct * (torch.ones_like(n) / n)

        return torch.func.vmap(acc_one)(stacked_params, x, y, live)


def make_cnn_task(kind: str = "smallcnn", n_classes: int = 10, hw: int = 16,
                  width: int = 16, device: str | torch.device = "cuda") -> Task:
    dev = setup_device(device)
    if kind == "smallcnn":
        return Task("smallcnn",
                    lambda g: cnn_mod.init_smallcnn(g, n_classes, width=width,
                                                    device=dev),
                    cnn_mod.smallcnn_apply,
                    cnn_mod.smallcnn_fwd_flops(n_classes, hw, width),
                    n_classes, dev)
    if kind == "resnet18":
        return Task("resnet18",
                    lambda g: cnn_mod.init_resnet18(g, n_classes, device=dev),
                    cnn_mod.resnet18_apply,
                    cnn_mod.resnet18_fwd_flops(n_classes, hw), n_classes, dev)
    if kind == "vgg11":
        return Task("vgg11",
                    lambda g: cnn_mod.init_vgg11(g, n_classes, device=dev),
                    cnn_mod.vgg11_apply,
                    cnn_mod.vgg11_fwd_flops(n_classes, hw), n_classes, dev)
    raise ValueError(kind)


@dataclasses.dataclass
class FLConfig:
    n_clients: int = 10
    rounds: int = 20
    local_epochs: int = 5
    batch_size: int = 32
    lr0: float = 0.1
    lr_decay: float = 0.998
    weight_decay: float = 5e-4
    momentum: float = 0.0
    topology: str = "random"            # random | ring | fc
    degree: int = 10
    seed: int = 0
    drop_prob: float = 0.0
    # sparsity
    density: float = 0.5
    capacities: Optional[list[float]] = None   # per-client densities
    alpha0: float = 0.5                  # initial prune rate (cosine annealed)
    # dispfl_anneal: end-of-run density of the cosine sparse-to-sparser
    # schedule (None -> density / 4)
    density_final: Optional[float] = None
    # Ditto / FOMO / fine-tuning
    prox_lambda: float = 0.75
    ft_epochs: int = 2
    eval_every: int = 1

    def lr_at(self, r: int) -> float:
        return self.lr0 * (self.lr_decay ** r)

    def client_density(self, k: int) -> float:
        if self.capacities is not None:
            return self.capacities[k]
        return self.density


@dataclasses.dataclass
class FLResult:
    acc_history: list[float]             # mean personalized test acc per eval
    final_accs: list[float]
    comm_busiest_mb: float               # per round
    comm_rows: dict
    flops_per_round: float               # per client
    flops_rows: dict
    rounds_to: dict[float, int] = dataclasses.field(default_factory=dict)

    @property
    def final_acc(self) -> float:
        return float(np.mean(self.final_accs))


def _pad_order(n: int, bs: int, rng: np.random.Generator) -> np.ndarray:
    order = rng.permutation(n)
    pad = (-len(order)) % bs
    if pad:
        order = np.concatenate([order, order[:pad]])
    return order


def local_sgd(task: Task, params: PyTree, x: np.ndarray, y: np.ndarray,
              epochs: int, batch_size: int, lr: float, opt: SGDConfig,
              rng: np.random.Generator, mask: Optional[PyTree] = None
              ) -> PyTree:
    """The paper's local phase (Alg. 1 lines 9-13): masked SGD with a mask,
    plain SGD without.  The client's data moves to the device once; batches
    are gathered there."""
    state = init_sgd(params, opt)
    bs = min(batch_size, len(y))
    xt, yt = task.as_tensor(x), task.as_tensor(y)
    for _ in range(epochs):
        order = _pad_order(len(y), bs, rng)
        for i in range(0, len(order), bs):
            sel = task.as_tensor(order[i: i + bs])
            _, grads = task.value_and_grad(params, xt[sel], yt[sel])
            if mask is not None:
                params, state = masked_sgd_step(params, grads, mask, state,
                                                opt, lr)
            else:
                params, state = sgd_step(params, grads, state, opt, lr)
    return params


def finetune_clients(task: Task, params: list[PyTree], clients, epochs: int,
                     batch_size: int, lr: float, opt: SGDConfig,
                     rng_for: Callable[[int], np.random.Generator],
                     mask=None) -> list[PyTree]:
    """Fine-tune every client from ``params[k]`` (the -FT eval variants).
    ``rng_for(k)`` supplies client k's generator; ``mask`` is one shared
    mask tree, a per-client list, or None."""
    out = []
    for k, c in enumerate(clients):
        m = mask[k] if isinstance(mask, list) else mask
        out.append(local_sgd(task, params[k], c.train_x, c.train_y, epochs,
                             batch_size, lr, opt, rng_for(k), mask=m))
    return out


def evaluate_clients(task: Task, client_params: list[PyTree],
                     clients) -> list[float]:
    return [task.accuracy(p, c.test_x, c.test_y)
            for p, c in zip(client_params, clients)]


def stack_eval_arrays(clients, device) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Pad the K ragged test sets to one (K, L, ...) batch on ``device``.

    Padding wraps each client's own test set (padded rows are valid inputs,
    never zeros) and a (K, L) ``live`` mask marks the real rows.  The
    arrays are round-invariant: build once and reuse."""
    L = max(len(c.test_y) for c in clients)
    xs, ys, lives = [], [], []
    for c in clients:
        n = len(c.test_y)
        idx = np.resize(np.arange(n), L)
        xs.append(c.test_x[idx])
        ys.append(c.test_y[idx])
        lives.append(np.arange(L) < n)
    return tuple(torch.as_tensor(np.stack(a), device=device)
                 for a in (xs, ys, lives))


def evaluate_clients_stacked(task: Task, stacked_params: PyTree, clients,
                             arrays=None) -> list[float]:
    """One vmapped launch in place of the per-client eval loop; equal to
    ``evaluate_clients`` bit for bit.  ``arrays`` is an optional pre-built
    ``stack_eval_arrays(clients, task.device)``."""
    if arrays is None:
        arrays = stack_eval_arrays(clients, task.device)
    return task.accuracy_stacked(stacked_params, *arrays).tolist()


def rounds_to_targets(history: list[float], targets: list[float]) -> dict[float, int]:
    out = {}
    for t in targets:
        out[t] = next((i + 1 for i, a in enumerate(history) if a >= t), -1)
    return out
