"""Partial-training decentralized variants (Shi et al., 2023): DFedAlt and
DFedSam, as engine hooks (reference ``repro.fl.partial``).

* ``dfedalt`` — the model splits into a *shared body* and a *personal
  head* (the classifier).  Local steps alternate: update the head with the
  body frozen, then the body with the head frozen.  Only the body crosses
  the wire (a partial packed payload: the message bitmap is zero on every
  head coordinate, so codec frames, accounting and the simulator's
  measured bytes all shrink by the head size), and the mix averages bodies
  over the in-neighbourhood while heads stay personal.

* ``dfedsam`` — D-PSGD's gossip with a SAM local phase: each step takes
  the gradient at the adversarially perturbed point ``w + rho * g / ||g||``
  (sharpness-aware minimization).  Payloads are full dense models
  (all-ones bitmap), like dpsgd's; so is its packed ``mix_one``.

Both use momentum-free SGD locally (the papers' setting).  The
neighbourhood mean and the gradient norm add their terms in the
reference's order (group order; leaves in leaf order), and the
perturbation stays in fp32 on the device (no read-back per step).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.accounting import (
    FlopsReport,
    decentralized_comm,
    sparse_training_flops,
)
from repro_torch.fl.base import FLConfig, Task, _pad_order, init_generator
from repro_torch.fl.decentralized import DPSGDStrategy
from repro_torch.fl.engine import RoundCtx, StrategyBase, register
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_nnz,
    tree_size,
)

PyTree = Any


def head_selector(path: str) -> bool:
    """The personal part: classifier leaves (``fc/...`` across the CNN zoo,
    ``head/...`` on the LM substrate)."""
    return path.startswith("fc") or path.startswith("head")


def split_masks(params: PyTree, selector=head_selector):
    """(body_sel, head_sel): complementary {0,1} float32 trees on the
    params' device."""
    head = tree_map_with_path(
        lambda p, x: torch.full(x.shape, 1.0 if selector(p) else 0.0,
                                dtype=torch.float32, device=x.device), params)
    body = tree_map(lambda h: 1.0 - h, head)
    return body, head


def _partial_sgd_step(params: PyTree, grads: PyTree, sel: PyTree,
                      lr: float, weight_decay: float) -> PyTree:
    """SGD on the selected coordinates only; frozen coordinates are left
    untouched (unlike ``masked_sgd_step``, which zeroes them — right for
    sparsity masks, wrong for a freeze)."""
    return tree_map(lambda w, g, s: w - lr * (g + weight_decay * w) * s,
                    params, grads, sel)


@register("dfedalt")
class DFedAltStrategy(StrategyBase):
    """State: ``{"params": [K trees]}``.  The body/head split is static
    given the architecture and lives on ``self`` (re-derived on resume)."""

    decentralized = True

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        if cfg.momentum != 0.0:
            raise ValueError("dfedalt implements momentum-free local SGD "
                             "(the paper's setting); set cfg.momentum=0")
        params = [task.init_fn(init_generator(cfg.seed, k, 0))
                  for k in range(len(clients))]
        self.body_sel, self.head_sel = split_masks(params[0])
        self.n_coords = tree_size(params[0])
        self.body_nnz = tree_nnz(self.body_sel)
        return {"params": params}

    # -- communication: bodies only ---------------------------------------
    def mix(self, state: dict, ctx: RoundCtx) -> None:
        a = ctx.adjacency
        params = state["params"]
        n = len(params)
        mixed = []
        for k in range(n):
            group = [k] + [j for j in range(n) if a[k, j] > 0 and j != k]
            inv = 1.0 / len(group)
            body = tree_map(lambda x: inv * x, params[group[0]])
            for j in group[1:]:
                body = tree_map(lambda u, v: u + inv * v, body, params[j])
            # personal head survives; shared body is the neighbourhood mean
            mixed.append(tree_map(lambda w, b, s: w * s + b * (1.0 - s),
                                  params[k], body, self.head_sel))
        state["params"] = mixed

    def local_mask(self, state: dict, k: int):
        # the message support: what dfedalt ships is the body —
        # snapshot_message, the codec and the accounting key off it
        return self.body_sel

    # -- alternating local phase ------------------------------------------
    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        cfg = ctx.cfg
        c = self.clients[k]
        rng = ctx.client_rng(k)
        params = state["params"][k]
        bs = min(cfg.batch_size, c.n_train)
        xt, yt = self.task.as_tensor(c.train_x), self.task.as_tensor(c.train_y)
        for _ in range(cfg.local_epochs):
            order = _pad_order(c.n_train, bs, rng)
            for i in range(0, len(order), bs):
                sel = self.task.as_tensor(order[i: i + bs])
                x, y = xt[sel], yt[sel]
                # personal part first, then the shared part at the updated
                # head (DFedAlt's alternating order)
                _, g = self.task.value_and_grad(params, x, y)
                params = _partial_sgd_step(params, g, self.head_sel,
                                           ctx.lr, cfg.weight_decay)
                _, g = self.task.value_and_grad(params, x, y)
                params = _partial_sgd_step(params, g, self.body_sel,
                                           ctx.lr, cfg.weight_decay)
        state["params"][k] = params

    # -- accounting --------------------------------------------------------
    def round_comm(self, state: dict, ctx: RoundCtx):
        n = len(self.clients)
        return decentralized_comm(ctx.adjacency, [self.body_nnz] * n,
                                  self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        # two alternating half-updates per batch, quoted as two full
        # forward+backward passes (a slight overcount of the halves)
        dense = sparse_training_flops(
            self.task.fwd_flops, {k: 1.0 for k in self.task.fwd_flops},
            self.n_samples, ctx.cfg.local_epochs, mask_search_batches=0,
            batch_size=ctx.cfg.batch_size)
        return FlopsReport(
            per_round_flops=2 * dense.per_round_flops,
            dense_per_round_flops=dense.dense_per_round_flops,
            fwd_flops_per_sample=dense.fwd_flops_per_sample)


def local_sam_sgd(task: Task, params: PyTree, x, y, epochs: int,
                  batch_size: int, lr: float, weight_decay: float,
                  rng: np.random.Generator, rho: float) -> PyTree:
    """SAM local phase: per batch, the update direction is the gradient at
    the adversarially perturbed point ``w + rho * g1 / ||g1||``.  The batch
    schedule is ``local_sgd``'s (the same ``_pad_order`` draws per epoch),
    so the derived-rng determinism contract holds."""
    bs = min(batch_size, len(y))
    xt, yt = task.as_tensor(x), task.as_tensor(y)
    for _ in range(epochs):
        order = _pad_order(len(y), bs, rng)
        for i in range(0, len(order), bs):
            sel = task.as_tensor(order[i: i + bs])
            xb, yb = xt[sel], yt[sel]
            _, g1 = task.value_and_grad(params, xb, yb)
            norm = torch.sqrt(sum(torch.sum(torch.square(le))
                                  for le in tree_leaves(g1)))
            scale = rho / (norm + 1e-12)
            w_adv = tree_map(lambda w, g: w + scale * g, params, g1)
            _, g2 = task.value_and_grad(w_adv, xb, yb)
            params = tree_map(lambda w, g: w - lr * (g + weight_decay * w),
                              params, g2)
    return params


@register("dfedsam")
class DFedSamStrategy(DPSGDStrategy):
    """D-PSGD gossip (Metropolis weights, full dense payloads) + SAM local
    steps.  Inherits dpsgd's mix, mix_one and payloads; only the local
    phase and the FLOPs accounting differ."""

    #: the SAM two-gradient step is not the stacked local phase's step
    vmap_capable = False

    def __init__(self, rho: float = 0.05):
        super().__init__(finetune=False, param_fraction=1.0)
        self.rho = float(rho)

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        if cfg.momentum != 0.0:
            raise ValueError("dfedsam implements momentum-free SAM-SGD; "
                             "set cfg.momentum=0")
        return super().init_state(task, clients, cfg)

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sam_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr,
            ctx.cfg.weight_decay, ctx.client_rng(k), self.rho)

    def round_flops(self, state: dict, ctx: RoundCtx):
        base = super().round_flops(state, ctx)
        # SAM doubles the per-batch gradient work (ascent + descent pass)
        return FlopsReport(
            per_round_flops=2 * base.per_round_flops,
            dense_per_round_flops=base.dense_per_round_flops,
            fwd_flops_per_sample=base.fwd_flops_per_sample)
