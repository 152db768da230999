"""Shared substrate for the strategies (reference ``repro.fl.base``).

A ``Task`` bundles a CNN backbone with its loss/grad/accuracy functions, the
per-layer analytic FLOPs map and the device everything runs on.
``local_sgd`` is the paper's local phase: E epochs of minibatch SGD (masked
when a mask is given) with batches padded to whole size, driven by a
per-client, per-round numpy generator (``fl.engine.derive_rng``) so batch
orders replay the reference's exactly; ``finetune_clients`` runs it from
each client's params for the -FT eval variants.

Compiled, as the reference jits them: ``Task.value_and_grad``,
``Task.accuracy`` (and ``accuracy_tensor``), ``Task.accuracy_stacked`` and
the local SGD step (value_and_grad plus the SGD update; ``local_sgd``'s
per client, and the vmap local phase's over K stacked clients) go through
``utils.graph.graphed`` — a CUDA graph per input signature on the card,
the eager functions on the CPU and under ``graph.disabled()``.  A step
runs on working buffers the ``Task`` owns, one set per signature (params,
momentum, mask, batch, learning rate): a phase copies its params and mask
in once, every step replays in place on them, and the result is copied
out once, so no client's tensors ever become a capture's buffers and a
phase of any length replays the one capture.  ``local_sgd`` moves a
phase's batch order to the device in one copy and gathers batches there
(the engine keeps its clients' data on the device, ``data.loader.
clients_on``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import setup_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.common import softmax_xent
from repro_torch.optim.sgd import SGDConfig, masked_sgd_step, sgd_step
from repro_torch.utils import graph
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

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

    def __post_init__(self):
        # the compiled bodies close over ``apply_fn``, not the task: a task
        # they referred to would be a reference cycle, which would hold
        # every capture's memory pool until Python's cyclic collector runs
        apply_fn = self.apply_fn
        self._vg = graph.graphed(
            lambda p, x, y: _value_and_grad(apply_fn, p, x, y))
        self._acc = graph.graphed(
            lambda p, x, y: _accuracy(apply_fn, p, x, y))
        self._acc_stacked = graph.graphed(
            lambda p, x, y, live: _accuracy_stacked(apply_fn, p, x, y, live))
        self._steps: dict[tuple[SGDConfig, bool], graph.Graphed] = {}
        self._work: dict[tuple, dict] = {}

    def as_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def graphs(self) -> list[graph.Graphed]:
        """The compiled functions, for their capture and replay counts."""
        return [self._vg, self._acc, self._acc_stacked, *self._steps.values()]

    def value_and_grad(self, params: PyTree, x, y):
        """(loss, grads) of the mean cross-entropy, grads keyed like params."""
        return self._vg(params, self.as_tensor(x), self.as_tensor(y))

    def accuracy_tensor(self, params: PyTree, x, y) -> torch.Tensor:
        """``accuracy`` as a 0-d fp32 tensor on the device, not read back."""
        return self._acc(params, self.as_tensor(x), self.as_tensor(y))

    def accuracy(self, params: PyTree, x, y) -> float:
        return float(self.accuracy_tensor(params, x, y))

    def accuracy_stacked(self, stacked_params: PyTree, x: torch.Tensor,
                         y: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """(K,) accuracies of K stacked models on (K, L, ...) padded test
        sets, over the rows ``live`` marks, in one vmapped call.  Per client
        ``sum(correct & live) * (1 / sum(live))``: 0/1 sums are exact in
        fp32, so each equals ``accuracy`` on the client's own rows."""
        return self._acc_stacked(stacked_params, x, y, live)

    def local_step(self, opt: SGDConfig, stacked: bool = False
                   ) -> graph.Graphed:
        """The local SGD step, compiled, every argument donated, so on the
        card it replays in place on ``working_buffers``.  Per client,
        ``step(w, state, mask, x, y, lr) -> (w, state)``: value_and_grad
        and the SGD update (masked with a mask tree, plain with ``None``).
        ``stacked``: ``step(w, state, mask, x, y, lr, alive)``, the same
        update vmapped over K stacked clients, a client whose ``alive`` is
        False left exactly as it was (``scale.stacked.stacked_sgd_step``)."""
        step = self._steps.get((opt, stacked))
        if step is None:
            apply_fn = self.apply_fn
            if stacked:
                # imported here: repro_torch.scale imports fl.engine
                from repro_torch.scale.stacked import stacked_sgd_step
                body = stacked_sgd_step(apply_fn, opt)
            else:
                def body(w, st, m, x, y, lr):
                    _, g = _value_and_grad(apply_fn, w, x, y)
                    if m is None:
                        return sgd_step(w, g, st, opt, lr)
                    return masked_sgd_step(w, g, m, st, opt, lr)

            step = self._steps[opt, stacked] = graph.graphed(
                body, donate=tuple(range(6 + stacked)))
        return step

    def working_buffers(self, params: PyTree, mask: Optional[PyTree],
                        opt: SGDConfig, lr: float, x: torch.Tensor,
                        y: torch.Tensor, alive: Optional[torch.Tensor] = None
                        ) -> dict:
        """The local step's buffers for this signature, loaded with
        ``params``, ``mask``, a zero momentum (``init_sgd``) and ``lr``;
        ``x``, ``y`` (and the stacked step's ``alive``) give one step's
        batch shapes, the caller fills them each step."""
        key = (opt, graph.signature((params, mask, x, y, alive)))
        work = self._work.get(key)
        if work is None:
            empty = lambda t: t.new_empty(t.shape)  # noqa: E731
            work = self._work[key] = {
                "w": tree_map(empty, params),
                "st": ({"mu": tree_map(empty, params)}
                       if opt.momentum != 0.0 else {}),
                "m": None if mask is None else tree_map(empty, mask),
                "x": empty(x), "y": empty(y),
                "alive": None if alive is None else empty(alive),
                "lr": torch.empty((), dtype=torch.float32, device=x.device)}
        torch._foreach_copy_(tree_leaves(work["w"]), tree_leaves(params))
        if mask is not None:
            torch._foreach_copy_(tree_leaves(work["m"]), tree_leaves(mask))
        if work["st"]:
            torch._foreach_zero_(tree_leaves(work["st"]))
        work["lr"].fill_(lr)
        return work


def _value_and_grad(apply_fn, params: PyTree, x, y):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    logits = apply_fn(tree_unflatten_like(params, leaves), x)
    loss = softmax_xent(logits, y)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten_like(params, grads)


@torch.no_grad()
def _accuracy(apply_fn, params: PyTree, x, y) -> torch.Tensor:
    pred = torch.argmax(apply_fn(params, x), dim=-1)
    correct = (pred == y).float().sum()
    # sum * (1/n) in fp32, the rounding of the reference's jitted mean
    # (XLA strength-reduces its divide-by-constant to a reciprocal multiply)
    return correct * (torch.ones_like(correct) / float(y.shape[0]))


@torch.no_grad()
def _accuracy_stacked(apply_fn, stacked_params: PyTree, x, y,
                      live) -> torch.Tensor:
    def acc_one(p, xk, yk, lk):
        pred = torch.argmax(apply_fn(p, xk), dim=-1)
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
    plain SGD without, one compiled step a batch on the task's working
    buffers.  The client's data stays on the device between phases; the
    phase's batch order moves there in one copy and batches are gathered
    there."""
    bs = min(batch_size, len(y))
    orders = [_pad_order(len(y), bs, rng) for _ in range(epochs)]
    if not orders:
        return params
    xt, yt = task.as_tensor(x), task.as_tensor(y)
    order = task.as_tensor(np.concatenate(orders))
    work = task.working_buffers(params, mask, opt, lr, xt[:bs], yt[:bs])
    step = task.local_step(opt)
    w, st = work["w"], work["st"]
    for i in range(0, order.numel(), bs):
        sel = order[i: i + bs]
        torch.index_select(xt, 0, sel, out=work["x"])
        torch.index_select(yt, 0, sel, out=work["y"])
        w, st = step(w, st, work["m"], work["x"], work["y"], work["lr"])
    # the working buffers outlive the phase: copy the result out
    return tree_map(torch.clone, w)


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
    """Each client's accuracy on its own test set, read back once."""
    return torch.stack([
        task.accuracy_tensor(p, c.test_x, c.test_y)
        for p, c in zip(client_params, clients)]).tolist()


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
        idx = torch.as_tensor(np.resize(np.arange(n), L), device=device)
        xs.append(torch.as_tensor(c.test_x, device=device)[idx])
        ys.append(torch.as_tensor(c.test_y, device=device)[idx])
        lives.append(torch.arange(L, device=device) < n)
    return tuple(torch.stack(a) for a in (xs, ys, lives))


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
