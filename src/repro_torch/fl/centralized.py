"""Centralized baselines (paper §4.1 / App. B.4) as engine hooks: Local,
FedAvg, FedAvg-FT, Ditto, FOMO, SubFedAvg (reference
``repro.fl.centralized``).

All share the busiest-node constraint: the server touches at most
``cfg.degree`` clients per round (matching the decentralized degree bound).
Client selection draws from the round-level rng stream, so it is
reproducible under resume and independent of client iteration order.
Initial params come from torch generators (``fl.base.init_generator``);
a run that must match the reference restores a reference archive.

Every weighted sum over trees adds its terms in the reference's order with
the same scalar types, so equal inputs give equal bits; SubFedAvg's server
mix is the gossip kernel over the selected clients' rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accounting import centralized_comm, sparse_training_flops
from repro_torch.core.evolve import _exact_topk_mask
from repro_torch.core.gossip import gossip_average_one
from repro_torch.core.masks import default_sparsifiable
from repro_torch.fl.base import (
    FLConfig,
    FLResult,
    Task,
    _pad_order,
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
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_nnz,
    tree_size,
    tree_unzip,
)


def _mean_trees(trees, weights=None):
    n = len(trees)
    if weights is None:
        weights = [1.0 / n] * n
    acc = tree_map(lambda x: weights[0] * x, trees[0])
    for w, t in zip(weights[1:], trees[1:]):
        acc = tree_map(lambda a, x: a + w * x, acc, t)
    return acc


def _dense_flops(task: Task, n_samples: int, cfg: FLConfig):
    return sparse_training_flops(
        task.fwd_flops, {k: 1.0 for k in task.fwd_flops}, n_samples,
        cfg.local_epochs, mask_search_batches=0, batch_size=cfg.batch_size)


def _select(ctx: RoundCtx, n_clients: int, n_sel: int) -> list[int]:
    """The round's selected clients, from the round stream."""
    return [int(k) for k in ctx.round_rng().choice(n_clients, size=n_sel,
                                                   replace=False)]


def _size_weighted_mean(clients, sel: list[int], locals_: dict):
    sizes = [clients[k].n_train for k in sel]
    weights = [s / sum(sizes) for s in sizes]
    return _mean_trees([locals_[k] for k in sel], weights)


# ---------------------------------------------------------------------------
# Local-only
# ---------------------------------------------------------------------------


@register("local")
class LocalStrategy(StrategyBase):
    vmap_capable = True

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        params = [task.init_fn(init_generator(cfg.seed, k, 0))
                  for k in range(len(clients))]
        self.n_coords = tree_size(params[0])
        return {"params": params}

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k))

    def round_comm(self, state: dict, ctx: RoundCtx):
        return centralized_comm(0, [0], self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        return _dense_flops(self.task, self.n_samples, ctx.cfg)


# ---------------------------------------------------------------------------
# FedAvg / FedAvg-FT
# ---------------------------------------------------------------------------


@register("fedavg", finetune=False)
@register("fedavg_ft", finetune=True)
class FedAvgStrategy(StrategyBase):
    """State: ``{"w_global": tree}``.  Selected clients train from the
    global model; ``post_round`` re-aggregates by sample counts.  The
    round's ``_sel``/``_locals`` entries exist only between ``mix`` and
    ``post_round``, so no archive holds them."""

    vmap_capable = True

    def __init__(self, finetune: bool = False):
        self.finetune = finetune

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        w0 = task.init_fn(init_generator(cfg.seed, 0, 0))
        self.n_sel = min(cfg.degree, len(clients))
        self.n_coords = tree_size(w0)
        return {"w_global": w0}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        state["_sel"] = _select(ctx, len(self.clients), self.n_sel)
        state["_locals"] = {}

    def active_clients(self, state: dict, ctx: RoundCtx):
        return state["_sel"]

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["_locals"][k] = local_sgd(
            self.task, state["w_global"], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k))

    # vmap adapters: every selected client starts from the global model
    def local_params(self, state: dict, k: int):
        return state["w_global"]

    def set_local(self, state: dict, k: int, params) -> None:
        state["_locals"][k] = params

    def post_round(self, state: dict, ctx: RoundCtx) -> None:
        sel = state.pop("_sel")
        state["w_global"] = _size_weighted_mean(self.clients, sel,
                                                state.pop("_locals"))

    def _broadcast(self, state: dict):
        return [state["w_global"]] * len(self.clients)

    def eval_params(self, state: dict, ctx: RoundCtx):
        params = self._broadcast(state)
        if not self.finetune:
            return params
        return finetune_clients(
            self.task, params, self.clients, self.cfg.ft_epochs,
            self.cfg.batch_size, ctx.lr, self.opt, ctx.eval_rng)

    def finalize_eval_params(self, state: dict):
        params = self._broadcast(state)
        if not self.finetune:
            return params
        cfg = self.cfg
        return finetune_clients(
            self.task, params, self.clients, cfg.ft_epochs, cfg.batch_size,
            cfg.lr_at(cfg.rounds), self.opt,
            lambda k: derive_rng(cfg.seed, cfg.rounds, k, stream=STREAM_EVAL))

    def round_comm(self, state: dict, ctx: RoundCtx):
        return centralized_comm(self.n_sel, [self.n_coords] * self.n_sel,
                                self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        return _dense_flops(self.task, self.n_samples, ctx.cfg)


# ---------------------------------------------------------------------------
# Ditto
# ---------------------------------------------------------------------------


@register("ditto")
class DittoStrategy(StrategyBase):
    """Global FedAvg trajectory + per-client personal model with a proximal
    pull toward the global model (Li et al. 2021b).  Per the paper's fair
    budget: 3 epochs on the global model, 2 on the personal one.  The
    interleaved prox loop keeps this on the per-client path (not vmap)."""

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        k_clients = len(clients)
        w_global = task.init_fn(init_generator(cfg.seed, 0, 0))
        personal = [task.init_fn(init_generator(cfg.seed, k + 1, 0))
                    for k in range(k_clients)]
        self.n_sel = min(cfg.degree, k_clients)
        self.n_coords = tree_size(w_global)
        self.g_epochs = max(1, (cfg.local_epochs * 3) // 5)
        self.p_epochs = max(1, cfg.local_epochs - self.g_epochs)
        return {"w_global": w_global, "personal": personal}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        state["_sel"] = _select(ctx, len(self.clients), self.n_sel)
        state["_locals"] = {}

    def active_clients(self, state: dict, ctx: RoundCtx):
        return state["_sel"]

    def _prox_step(self, params, ref, x, y, lr):
        cfg = self.cfg
        _, grads = self.task.value_and_grad(params, x, y)
        grads = tree_map(lambda g, w, r: g + cfg.prox_lambda * (w - r),
                         grads, params, ref)
        return tree_map(lambda w, g: w - lr * (g + cfg.weight_decay * w),
                        params, grads)

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        cfg = ctx.cfg
        rng = ctx.client_rng(k)
        w_global = state["w_global"]
        state["_locals"][k] = local_sgd(
            self.task, w_global, c.train_x, c.train_y, self.g_epochs,
            cfg.batch_size, ctx.lr, self.opt, rng)
        # personal model: prox-SGD toward the (old) global model
        v = state["personal"][k]
        bs = min(cfg.batch_size, c.n_train)
        xt, yt = self.task.as_tensor(c.train_x), self.task.as_tensor(c.train_y)
        for _ in range(self.p_epochs):
            order = _pad_order(c.n_train, bs, rng)
            for i in range(0, len(order), bs):
                s = self.task.as_tensor(order[i: i + bs])
                v = self._prox_step(v, w_global, xt[s], yt[s], ctx.lr)
        state["personal"][k] = v

    def post_round(self, state: dict, ctx: RoundCtx) -> None:
        sel = state.pop("_sel")
        state["w_global"] = _size_weighted_mean(self.clients, sel,
                                                state.pop("_locals"))

    def local_params(self, state: dict, k: int):
        # what a Ditto client puts on the wire is its copy of the global
        # model (the personal model never leaves the device)
        return state["w_global"]

    def set_local(self, state: dict, k: int, params) -> None:
        state["w_global"] = params

    def eval_params(self, state: dict, ctx: RoundCtx):
        return state["personal"]

    def finalize_eval_params(self, state: dict):
        return state["personal"]

    def round_comm(self, state: dict, ctx: RoundCtx):
        return centralized_comm(self.n_sel, [self.n_coords] * self.n_sel,
                                self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        return _dense_flops(self.task, self.n_samples, ctx.cfg)


# ---------------------------------------------------------------------------
# FOMO
# ---------------------------------------------------------------------------


@register("fomo")
class FOMOStrategy(StrategyBase):
    """First-order model optimization (Zhang et al. 2020): clients weight
    the received models by the first-order utility
        u_j = max(L_k(w_k) - L_k(w_j), 0) / ||w_j - w_k||
    and move toward the useful ones before local training.  The losses and
    norms are read back to the host (Python floats), as in the reference,
    since the branch on the utility's sign is taken there."""

    vmap_capable = True

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        params = [task.init_fn(init_generator(cfg.seed, k, 0))
                  for k in range(len(clients))]
        self.n_nbrs = min(cfg.degree, len(clients) - 1)
        self.n_coords = tree_size(params[0])
        return {"params": params}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        params = state["params"]
        k_clients = len(params)
        mixed_all = []
        for k in range(k_clients):
            rng = ctx.client_rng(k)
            c = self.clients[k]
            xb, yb = (self.task.as_tensor(a) for a in
                      c.sample_batch(rng, ctx.cfg.batch_size))
            own_loss, _ = self.task.value_and_grad(params[k], xb, yb)
            nbrs = rng.choice([j for j in range(k_clients) if j != k],
                              size=self.n_nbrs, replace=False)
            mixed = params[k]
            weights, deltas = [], []
            for j in nbrs:
                lj, _ = self.task.value_and_grad(params[j], xb, yb)
                delta = tree_map(torch.sub, params[j], params[k])
                # summed over leaves in leaf order, as the reference does
                norm = float(torch.sqrt(sum(torch.sum(torch.square(d))
                                            for d in tree_leaves(delta)))) + 1e-8
                u = max(float(own_loss) - float(lj), 0.0) / norm
                weights.append(u)
                deltas.append(delta)
            tot = sum(weights)
            if tot > 0:
                for u, d in zip(weights, deltas):
                    mixed = tree_map(lambda m, x: m + (u / tot) * x, mixed, d)
            mixed_all.append(mixed)
        state["params"] = mixed_all

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k))

    def round_comm(self, state: dict, ctx: RoundCtx):
        n = self.n_nbrs
        return centralized_comm(n, [self.n_coords] * n, self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        return _dense_flops(self.task, self.n_samples, ctx.cfg)


# ---------------------------------------------------------------------------
# SubFedAvg (dense-to-sparse personalized subnetworks)
# ---------------------------------------------------------------------------


@register("subfedavg")
class SubFedAvgStrategy(StrategyBase):
    """Vahidian et al. 2021: clients start dense and iteratively magnitude-
    prune toward ``cfg.density`` as rounds progress; the server averages on
    the unpruned intersections (DisPFL's intersection gossip, one gossip
    kernel launch per leaf and selected client, but star topology and
    dense-to-sparse)."""

    vmap_capable = True

    def __init__(self, prune_per_round: float = 0.05):
        self.prune_per_round = prune_per_round

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        super().init_state(task, clients, cfg)
        k_clients = len(clients)
        w0 = task.init_fn(init_generator(cfg.seed, 0, 0))
        params = [tree_map(torch.clone, w0) for _ in range(k_clients)]
        masks = [tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32,
                                               device=x.device), w0)
                 for _ in range(k_clients)]
        self.n_sel = min(cfg.degree, k_clients)
        self.n_coords = tree_size(w0)
        return {"params": params, "masks": masks}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        sel = _select(ctx, len(self.clients), self.n_sel)
        state["_sel"] = sel
        params, masks = state["params"], state["masks"]
        averaged = {}
        for k in sel:
            others = [j for j in sel if j != k]
            averaged[k] = gossip_average_one(
                params[k], masks[k],
                [params[j] for j in others], [masks[j] for j in others])
        for k in sel:
            state["params"][k] = averaged[k]

    def active_clients(self, state: dict, ctx: RoundCtx):
        return state["_sel"]

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k), mask=state["masks"][k])

    def local_mask(self, state: dict, k: int):
        return state["masks"][k]

    def evolve(self, state: dict, k: int, ctx: RoundCtx) -> None:
        # dense-to-sparse: magnitude-prune a further slice per round
        if _tree_density(state["masks"][k]) > ctx.cfg.density:
            state["masks"][k], state["params"][k] = _magnitude_prune(
                state["params"][k], state["masks"][k], self.prune_per_round,
                ctx.cfg.density)

    def post_round(self, state: dict, ctx: RoundCtx) -> None:
        state.pop("_sel")

    def round_comm(self, state: dict, ctx: RoundCtx):
        # worst case: the server's n_sel connections carry the heaviest
        # current models (centralized_comm truncates to n_sel)
        nnz = sorted((tree_nnz(state["masks"][k]) for k in
                      range(len(self.clients))), reverse=True)
        return centralized_comm(self.n_sel, nnz, self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        mean_density = float(np.mean(
            [_tree_density(m) for m in state["masks"]]))
        densities = {k: mean_density for k in self.task.fwd_flops}
        return sparse_training_flops(
            self.task.fwd_flops, densities, self.n_samples,
            ctx.cfg.local_epochs, mask_search_batches=0,
            batch_size=ctx.cfg.batch_size)


def _tree_density(mask) -> float:
    tot = tree_size(mask)
    return tree_nnz(mask) / max(tot, 1)


def _magnitude_prune(params, mask, rate: float, floor: float):
    """Prune ``rate`` of remaining weights per sparsifiable layer (not below
    ``floor`` density); returns (new_mask, new_params)."""

    def one(path, w, m):
        if not default_sparsifiable(path, w):
            return m, w
        n = w.numel()
        cur = int((m > 0).sum())
        target = max(int(n * floor), int(cur * (1.0 - rate)))
        if target >= cur:
            return m, w
        scores = torch.where(m.reshape(-1) > 0, w.reshape(-1).abs(),
                             torch.full((), float("-inf"), device=w.device))
        new_m = _exact_topk_mask(scores, target).reshape(w.shape)
        return new_m.to(m.dtype), w * new_m.to(w.dtype)

    return tree_unzip(tree_map_with_path(one, params, mask))


# ---------------------------------------------------------------------------
# Run wrappers (engine run -> FLResult)
# ---------------------------------------------------------------------------


def run_local(task: Task, clients, cfg: FLConfig, targets=(0.5,),
              **engine_kw) -> FLResult:
    return run_strategy("local", task, clients, cfg, targets=targets,
                        **engine_kw)


def run_fedavg(task: Task, clients, cfg: FLConfig, finetune: bool = False,
               targets=(0.5,), **engine_kw) -> FLResult:
    return run_strategy("fedavg", task, clients, cfg, targets=targets,
                        finetune=finetune, **engine_kw)


def run_ditto(task: Task, clients, cfg: FLConfig, targets=(0.5,),
              **engine_kw) -> FLResult:
    return run_strategy("ditto", task, clients, cfg, targets=targets,
                        **engine_kw)


def run_fomo(task: Task, clients, cfg: FLConfig, targets=(0.5,),
             **engine_kw) -> FLResult:
    return run_strategy("fomo", task, clients, cfg, targets=targets,
                        **engine_kw)


def run_subfedavg(task: Task, clients, cfg: FLConfig,
                  prune_per_round: float = 0.05, targets=(0.5,),
                  **engine_kw) -> FLResult:
    return run_strategy("subfedavg", task, clients, cfg, targets=targets,
                        prune_per_round=prune_per_round, **engine_kw)
