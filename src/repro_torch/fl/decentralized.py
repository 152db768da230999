"""Decentralized baselines: D-PSGD and D-PSGD-FT (Lian et al. 2017;
FL-adapted with multi-epoch local phases per Sun et al. 2021), as engine
hooks (reference ``repro.fl.decentralized``).

Gossip uses Metropolis-Hastings weights on the symmetrized topology (doubly
stochastic), then each client runs E local epochs.  The -FT variant
evaluates after ``ft_epochs`` of local fine-tuning from the consensus model
(paper App. B.4), leaving the consensus trajectory untouched.

``param_fraction`` is the hardware-constrained baseline of §4.3: every
client trains only a fixed random ``param_fraction`` subnetwork of the
dense model (the same mask for all clients).  The mask is static, drawn by
``init_state`` from a torch generator at the reference's ERK densities
(the same budget as the reference's ``jax.random`` draw, other bits).

The mix sums each receiver's terms in sender order, skipping zero weights,
one rounded multiply and add per term, as the reference does, so equal
inputs mix to equal bits.  The async simulator's ``mix_one`` folds each
arrived payload with the packed-fold kernel at its Metropolis weight.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accounting import decentralized_comm, sparse_training_flops
from repro_torch.core.masks import apply_mask, erk_densities_for_params, init_mask
from repro_torch.fl.base import (
    FLConfig,
    FLResult,
    Task,
    finetune_clients,
    init_generator,
    local_sgd,
)
from repro_torch.fl.engine import (
    STREAM_EVAL,
    RoundCtx,
    StrategyBase,
    derive_rng,
    register,
    run_strategy,
)
from repro_torch.sparse.ops import packed_axpy
from repro_torch.utils.tree import tree_map, tree_nnz, tree_size


def metropolis_weights(a: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings mixing matrix of the symmetrized topology:
    W[i,j] = 1/(1+max(deg_i, deg_j)) on edges, the diagonal absorbs the
    rest; doubly stochastic and symmetric."""
    sym = ((a + a.T) > 0).astype(float)
    np.fill_diagonal(sym, 0.0)
    deg = sym.sum(1)
    w = sym / (1.0 + np.maximum(deg[:, None], deg[None, :]))
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


@register("dpsgd", finetune=False)
@register("dpsgd_ft", finetune=True)
class DPSGDStrategy(StrategyBase):
    """State: ``{"params": [K trees]}``.  The optional shared
    ``param_fraction`` mask is static and re-derived on resume."""

    vmap_capable = True
    decentralized = True

    def __init__(self, finetune: bool = False, param_fraction: float = 1.0):
        self.finetune = finetune
        self.param_fraction = param_fraction

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        w0 = task.init_fn(init_generator(cfg.seed, 0, 0))
        self.mask = None
        self.densities: dict[str, float] = {}
        if self.param_fraction < 1.0:
            self.densities = erk_densities_for_params(w0, self.param_fraction)
            self.mask = init_mask(init_generator(cfg.seed + 1, 0, 1), w0,
                                  self.param_fraction)
            w0 = apply_mask(w0, self.mask)
        self.n_coords = tree_size(w0)
        return {"params": [tree_map(torch.clone, w0) for _ in clients]}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        w_mix = metropolis_weights(ctx.adjacency)
        params = state["params"]
        k_clients = len(params)
        mixed = []
        for k in range(k_clients):
            acc = None
            for j in range(k_clients):
                if w_mix[k, j] == 0.0:
                    continue
                w = float(w_mix[k, j])
                contrib = tree_map(lambda x: w * x, params[j])
                acc = contrib if acc is None else tree_map(
                    torch.add, acc, contrib)
            mixed.append(acc)
        state["params"] = mixed

    def mix_one(self, state: dict, k: int, senders: dict[int, dict],
                ctx: RoundCtx) -> None:
        """O(degree · nnz) per-activation mixing: Metropolis weights on k's
        star neighbourhood, each arrived payload folded in packed at its
        weight (dense models ride an all-ones bitmap), no other client
        touched."""
        if not senders:
            return
        n = len(state["params"])
        a = np.eye(n)
        a[k, sorted(senders)] = 1.0
        w_mix = metropolis_weights(a)
        own = float(w_mix[k, k])
        acc = tree_map(lambda x: own * x, state["params"][k])
        for j in sorted(senders):
            acc = packed_axpy(acc, senders[j]["packed"], float(w_mix[k, j]))
        state["params"][k] = acc

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k), mask=self.mask)

    def local_mask(self, state: dict, k: int):
        return self.mask

    def eval_params(self, state: dict, ctx: RoundCtx):
        if not self.finetune:
            return state["params"]
        return finetune_clients(
            self.task, state["params"], self.clients, self.cfg.ft_epochs,
            self.cfg.batch_size, ctx.lr, self.opt, ctx.eval_rng,
            mask=self.mask)

    def finalize_eval_params(self, state: dict):
        if not self.finetune:
            return state["params"]
        cfg = self.cfg
        return finetune_clients(
            self.task, state["params"], self.clients, cfg.ft_epochs,
            cfg.batch_size, cfg.lr_at(cfg.rounds), self.opt,
            lambda k: derive_rng(cfg.seed, cfg.rounds, k, stream=STREAM_EVAL),
            mask=self.mask)

    def round_comm(self, state: dict, ctx: RoundCtx):
        per = (tree_nnz(self.mask) if self.mask is not None
               else self.n_coords)
        return decentralized_comm(ctx.adjacency,
                                  [per] * len(self.clients), self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        dens = self.densities or {k: 1.0 for k in self.task.fwd_flops}
        return sparse_training_flops(
            self.task.fwd_flops, dens, self.n_samples, ctx.cfg.local_epochs,
            mask_search_batches=0, batch_size=ctx.cfg.batch_size)


def run_dpsgd(task: Task, clients, cfg: FLConfig, finetune: bool = False,
              param_fraction: float = 1.0, targets=(0.5,),
              **engine_kw) -> FLResult:
    """Engine run -> FLResult."""
    return run_strategy("dpsgd", task, clients, cfg, targets=targets,
                        finetune=finetune, param_fraction=param_fraction,
                        **engine_kw)
