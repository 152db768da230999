"""DisPFL (paper Alg. 1) as engine hooks (reference ``repro.fl.dispfl``).

Per round, for every client k:
  1. ``mix``: intersection-weighted gossip with the neighbours of the
     round's topology, re-masked by m_k,
  2. ``local_update``: E epochs of masked SGD,
  3. ``evolve``: dense gradient on one batch, then cosine-annealed magnitude
     prune + gradient regrow inside the ERK budgets (Alg. 2).

The default ``packed=True`` mix runs on packed payloads: each sender is
packed once (bitmap + nnz values, the message a link would carry), each
payload is decoded once by folding it into zero accumulators with the
packed-fold kernel, and each receiver's ``gossip_average_one`` runs the
gossip kernel over its rows, self first, then neighbours in ascending
order.  ``packed=False`` runs the same gossip kernel on the dense state.
Both equal the reference's mix bit for bit.  The async simulator's
per-activation ``mix_one`` folds each arrived payload straight into the
receiver's accumulators with the packed-fold kernel and finalizes them
with the gossip kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accounting import decentralized_comm, sparse_training_flops
from repro_torch.core.evolve import evolve_masks, layer_nnz_budgets
from repro_torch.core.gossip import gossip_average_one
from repro_torch.core.masks import (
    annealed_density,
    apply_mask,
    erk_densities_for_params,
    init_mask,
)
from repro_torch.fl.base import FLConfig, FLResult, Task, init_generator, local_sgd
from repro_torch.fl.engine import RoundCtx, StrategyBase, register, run_strategy
from repro_torch.sparse.ops import decode_tree, packed_gossip_one
from repro_torch.sparse.packed import pack_tree
from repro_torch.utils.tree import tree_nnz_each, tree_size


@register("dispfl")
class DisPFLStrategy(StrategyBase):
    """State: ``{"params": [K trees], "masks": [K trees]}``.  ERK budgets and
    densities are static given (cfg, model) and live on ``self``.

    ``payload_dtype="fp16"`` casts each held value to fp16 at the message
    boundary (masks unchanged); receivers mix the cast values in fp32."""

    vmap_capable = True
    decentralized = True

    def __init__(self, packed: bool = True, payload_dtype: str = "fp32"):
        if payload_dtype not in ("fp32", "fp16"):
            raise ValueError(
                f"payload_dtype must be fp32|fp16, got {payload_dtype!r}")
        if payload_dtype == "fp16" and not packed:
            raise ValueError("payload_dtype='fp16' requires packed=True "
                             "(the cast happens at the message boundary)")
        self.packed = packed
        self.payload_dtype = payload_dtype
        self._wire_dtype = torch.float16 if payload_dtype == "fp16" else None

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        """Fresh params and Bernoulli ERK masks from torch generators (they
        cannot replay the reference's ``jax.random`` draws; a run that must
        match the reference restores a reference archive instead)."""
        super().init_state(task, clients, cfg)
        k_clients = len(clients)
        params, masks = _draw_state(task, cfg, k_clients)
        self.densities = [
            erk_densities_for_params(params[k], cfg.client_density(k))
            for k in range(k_clients)]
        self.budgets = [layer_nnz_budgets(params[k], self.densities[k])
                        for k in range(k_clients)]
        self.n_coords = tree_size(params[0])
        return {"params": params, "masks": masks}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        a = ctx.adjacency
        params, masks = state["params"], state["masks"]
        k_clients = len(params)
        nbrs_of = [[j for j in range(k_clients) if a[k, j] > 0 and j != k]
                   for k in range(k_clients)]
        if self.packed:
            senders = sorted({j for nbrs in nbrs_of for j in nbrs})
            decoded = {j: decode_tree(pack_tree(params[j], masks[j],
                                                dtype=self._wire_dtype))
                       for j in senders}
            state["params"] = [
                gossip_average_one(params[k], masks[k],
                                   [decoded[j][0] for j in nbrs_of[k]],
                                   [decoded[j][1] for j in nbrs_of[k]])
                for k in range(k_clients)]
            return
        state["params"] = [
            gossip_average_one(params[k], masks[k],
                               [params[j] for j in nbrs_of[k]],
                               [masks[j] for j in nbrs_of[k]])
            for k in range(k_clients)]

    def mix_one(self, state: dict, k: int, senders: dict[int, dict],
                ctx: RoundCtx) -> None:
        """Per-activation gossip folding exactly the arrived packed payloads
        (``{j: {"packed": tree}}``) — O(degree) folds."""
        if not senders:
            return
        packs = [senders[j]["packed"] for j in sorted(senders)]
        state["params"][k] = packed_gossip_one(
            state["params"][k], state["masks"][k], packs)

    def snapshot_message(self, state: dict, k: int) -> dict:
        """What k transmits: its packed masked model in the wire dtype."""
        return {"packed": pack_tree(state["params"][k], state["masks"][k],
                                    dtype=self._wire_dtype)}

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        c = self.clients[k]
        state["params"][k] = local_sgd(
            self.task, state["params"][k], c.train_x, c.train_y,
            ctx.cfg.local_epochs, ctx.cfg.batch_size, ctx.lr, self.opt,
            ctx.client_rng(k), mask=state["masks"][k])

    def local_mask(self, state: dict, k: int):
        return state["masks"][k]

    def budgets_at(self, t: int, k: int) -> dict[str, int]:
        return self.budgets[k]

    def evolve(self, state: dict, k: int, ctx: RoundCtx) -> None:
        xb, yb = self.clients[k].sample_batch(ctx.client_rng(k),
                                              ctx.cfg.batch_size)
        _, g = self.task.value_and_grad(state["params"][k], xb, yb)
        state["masks"][k], state["params"][k] = evolve_masks(
            state["params"][k], state["masks"][k], g, ctx.prune_rate,
            self.budgets_at(ctx.t, k))

    def round_comm(self, state: dict, ctx: RoundCtx):
        nnz = tree_nnz_each(state["masks"])
        return decentralized_comm(ctx.adjacency, nnz, self.n_coords)

    def round_flops(self, state: dict, ctx: RoundCtx):
        return sparse_training_flops(
            self.task.fwd_flops, _mean_density(self.densities),
            self.n_samples, ctx.cfg.local_epochs,
            mask_search_batches=1, batch_size=ctx.cfg.batch_size)


def _mean_density(densities: list[dict[str, float]]) -> dict[str, float]:
    keys = densities[0].keys()
    return {k: float(np.mean([d[k] for d in densities])) for k in keys}


@register("dispfl_anneal")
class DisPFLAnnealStrategy(DisPFLStrategy):
    """DA-DPFL-style sparse-to-sparser training (Long et al., 2024): the
    per-client mask budget follows a cosine density schedule from
    ``cfg.density`` down to ``density_final`` (default ``cfg.density_final``
    or a quarter of the start), so payloads shrink round over round."""

    def __init__(self, density_final: float | None = None,
                 packed: bool = True, payload_dtype: str = "fp32"):
        super().__init__(packed=packed, payload_dtype=payload_dtype)
        self.density_final = density_final

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        state = super().init_state(task, clients, cfg)
        self._d_final = (self.density_final if self.density_final is not None
                         else cfg.density_final or cfg.density / 4.0)
        self._template = state["params"][0]      # shapes only
        self._budget_cache: dict[tuple[int, float], dict[str, int]] = {}
        self._flops_density_cache: dict[int, dict[str, float]] = {}
        return state

    def density_at(self, t: int, k: int = 0) -> float:
        d0 = self.cfg.client_density(k)
        d_end = self._d_final * d0 / self.cfg.density
        return annealed_density(d0, d_end, t, self.cfg.rounds)

    def budgets_at(self, t: int, k: int) -> dict[str, int]:
        # the annealed budget both prunes (down to the schedule) and regrows
        # (within it): nnz(mask) == budget exactly after each round
        key = (t, self.cfg.client_density(k))
        if key not in self._budget_cache:
            dens = erk_densities_for_params(self._template,
                                            self.density_at(t, k))
            self._budget_cache[key] = layer_nnz_budgets(self._template, dens)
        return self._budget_cache[key]

    def round_flops(self, state: dict, ctx: RoundCtx):
        if ctx.t not in self._flops_density_cache:
            self._flops_density_cache[ctx.t] = _mean_density([
                erk_densities_for_params(self._template,
                                         self.density_at(ctx.t, k))
                for k in range(len(self.clients))])
        return sparse_training_flops(
            self.task.fwd_flops, self._flops_density_cache[ctx.t],
            self.n_samples, ctx.cfg.local_epochs,
            mask_search_batches=1, batch_size=ctx.cfg.batch_size)


def run_dispfl(task: Task, clients, cfg: FLConfig, targets=(0.5,),
               **engine_kw) -> FLResult:
    """Engine run -> FLResult."""
    return run_strategy("dispfl", task, clients, cfg, targets=targets,
                        **engine_kw)


def _draw_state(task: Task, cfg: FLConfig, k_clients: int):
    """K clients' ``w ⊙ m`` and Bernoulli ERK masks, each client's params
    and mask drawn from its own generator (``init_generator``)."""
    params = [task.init_fn(init_generator(cfg.seed, k, 0))
              for k in range(k_clients)]
    masks = [init_mask(init_generator(cfg.seed, k, 1), params[k],
                       cfg.client_density(k))
             for k in range(k_clients)]
    return [apply_mask(p, m) for p, m in zip(params, masks)], masks


def dispfl_state(task: Task, cfg: FLConfig):
    """Expose (params, masks) init for tests/examples: the state a dispfl
    run of ``cfg`` starts from, drawn from torch generators seeded by
    ``cfg.seed`` (the reference's draws are ``jax.random``'s)."""
    return _draw_state(task, cfg, cfg.n_clients)
