"""Stacked strategy adapters: a registered strategy's round phases over
client-stacked state (reference ``repro.scale.strategy``).

An adapter wraps an existing ``StrategyBase`` instance — the one the loop
engine drives — and re-expresses its phases on stacked (K-leading) state:

    stack_state / unstack_state   per-client lists <-> stacked trees
    mix_matrix(ctx)               (K, K) host matrix for the mix
    mix_input(ctx, device)        the mix's device input for the round step
    stacked_mix(state, mix, full, receivers)
                                  the communication phase (``full``: the
                                  K senders, when ``state`` holds only
                                  receivers ``k0:k1`` of a sharded round)
    stacked_masks(state)          masks for the local phase
    stacked_evolve(state, grads, counts)   the mask search
    evolve_counts(ctx)            per-round host counts for the search
                                  (the engine hands them to its step as
                                  device tensors)

plus ``round_comm``/``round_flops`` (the base strategy's accounting) and
``eval_params``/``stacked_eval_params``.  ``ScaleEngine`` composes them:
mix -> local phase -> evolve.  Adapters are looked up by the registered
strategy name; ``make_stacked`` raises with the supported list otherwise.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.accounting import decentralized_comm
from repro_torch.core.topology import max_in_degree
from repro_torch.fl.decentralized import metropolis_weights
from repro_torch.fl.engine import RoundCtx, StrategyBase
from repro_torch.scale.stacked import (
    check_reduction,
    evolve_counts_for,
    in_neighbour_index,
    masked_gossip_stacked,
    plain_mix_stacked,
    stacked_evolve_exact,
    stacked_nnz_per_client,
)
from repro_torch.utils.tree import tree_stack, tree_unstack

PyTree = Any

_STACKED_REGISTRY: dict[str, type] = {}


def register_stacked(*names: str):
    """Class decorator: map registered strategy names to their adapter."""

    def deco(cls):
        for name in names:
            _STACKED_REGISTRY[name] = cls
        return cls

    return deco


def stacked_strategy_names() -> list[str]:
    return sorted(_STACKED_REGISTRY)


def make_stacked(strategy: StrategyBase,
                 reduction: str = "einsum") -> "StackedStrategyBase":
    """The adapter for an already-constructed strategy instance."""
    cls = _STACKED_REGISTRY.get(strategy.name)
    if cls is None:
        raise KeyError(
            f"strategy '{strategy.name}' has no stacked adapter; "
            f"supported: {stacked_strategy_names()}")
    return cls(strategy, reduction=reduction)


class StackedStrategyBase:
    """Default adapter plumbing; subclasses fill in the phases."""

    #: state keys that carry per-client lists in the base strategy's state
    state_keys: tuple[str, ...] = ("params",)
    #: whether the strategy runs a post-local mask search
    evolves: bool = False

    def __init__(self, base: StrategyBase, reduction: str = "einsum"):
        check_reduction(reduction)
        self.base = base
        self.reduction = reduction

    @property
    def name(self) -> str:
        return self.base.name

    # -- lifecycle ---------------------------------------------------------
    def validate(self, cfg) -> None:
        """Reject configurations the stacked round cannot express."""
        if cfg.capacities is not None:
            raise ValueError(
                "ScaleEngine requires homogeneous client densities "
                "(cfg.capacities=None); heterogeneous capacities imply "
                "per-client layer budgets, which the stacked evolve cannot "
                "batch — use RoundEngine")

    def stack_state(self, state: dict) -> dict:
        """Per-client lists (``state_keys``) -> stacked trees; other
        entries pass through."""
        return {k: tree_stack(v) if k in self.state_keys else v
                for k, v in state.items()}

    def unstack_state(self, state: dict) -> dict:
        kdim = len(self.base.clients)
        return {k: tree_unstack(v, kdim) if k in self.state_keys else v
                for k, v in state.items()}

    # -- phases ------------------------------------------------------------
    def mix_matrix(self, ctx: RoundCtx) -> np.ndarray:
        raise NotImplementedError

    def mix_input(self, ctx: RoundCtx, device):
        """What ``stacked_mix`` takes as ``mix``, on ``device``: the
        round's matrix as a float32 tensor."""
        return torch.as_tensor(self.mix_matrix(ctx), dtype=torch.float32,
                               device=device)

    def stacked_mix(self, state: dict, mix, full: Optional[dict] = None,
                    receivers: Optional[tuple[int, int]] = None) -> dict:
        """The mix of ``state``'s clients.  A client-sharded round passes
        ``full``, the gathered K senders' state, and ``receivers``, the
        (k0, k1) rows ``state`` holds."""
        raise NotImplementedError

    def stacked_masks(self, state: dict) -> Optional[PyTree]:
        """Stacked masks for the local phase (None = unmasked SGD)."""
        return None

    def stacked_evolve(self, state: dict, grads: PyTree,
                       counts: dict) -> dict:
        return state

    def evolve_counts(self, ctx: RoundCtx) -> dict:
        return {}

    # -- evaluation / accounting ------------------------------------------
    def eval_params(self, state: dict) -> list[PyTree]:
        return tree_unstack(state["params"], len(self.base.clients))

    def stacked_eval_params(self, state: dict) -> PyTree:
        """The stacked personalized params for the vmapped eval — the same
        models as ``eval_params``, without the unstack."""
        return state["params"]

    def round_comm(self, state: dict, ctx: RoundCtx,
                   nnz: Optional[list[int]] = None):
        """The round's ``CommReport``; ``nnz``, each client's message nnz
        (all K), when ``state`` holds a shard of them."""
        raise NotImplementedError

    def round_flops(self, ctx: RoundCtx):
        return self.base.round_flops({}, ctx)


@register_stacked("dispfl", "dispfl_anneal")
class StackedDisPFL(StackedStrategyBase):
    """DisPFL (and its sparse-to-sparser anneal) in stacked form: the
    intersection gossip as the adjacency-weighted masked fold, masked local
    SGD, exact batched prune/regrow with per-round counts (the anneal
    schedule changes only the counts)."""

    state_keys = ("params", "masks")
    evolves = True

    def validate(self, cfg) -> None:
        super().validate(cfg)
        if getattr(self.base, "payload_dtype", "fp32") != "fp32":
            raise ValueError(
                "ScaleEngine's stacked mix computes on dense fp32 state and "
                "never crosses a message boundary, so payload_dtype='fp16' "
                "would silently have no effect — use RoundEngine for "
                "half-precision wire payloads")

    def mix_matrix(self, ctx: RoundCtx) -> np.ndarray:
        return np.asarray(ctx.adjacency, dtype=np.float32)

    def mix_input(self, ctx: RoundCtx, device):
        """The ``ordered`` mix takes the (K, J) in-neighbour index, J fixed
        by the topology's in-degree bound: one shape, so one captured step,
        for every round and every drop."""
        if self.reduction == "ordered":
            cfg = ctx.cfg
            k = len(self.base.clients)
            return in_neighbour_index(
                self.mix_matrix(ctx),
                1 + max_in_degree(cfg.topology, k, cfg.degree), device)
        return super().mix_input(ctx, device)

    def stacked_mix(self, state: dict, mix, full: Optional[dict] = None,
                    receivers: Optional[tuple[int, int]] = None) -> dict:
        src = state if full is None else full
        params = masked_gossip_stacked(src["params"], src["masks"], mix,
                                       reduction=self.reduction,
                                       receivers=receivers)
        return {**state, "params": params}

    def stacked_masks(self, state: dict) -> PyTree:
        return state["masks"]

    def stacked_evolve(self, state: dict, grads: PyTree,
                       counts: dict) -> dict:
        masks, params = stacked_evolve_exact(state["params"], state["masks"],
                                             grads, counts)
        return {"params": params, "masks": masks}

    def evolve_counts(self, ctx: RoundCtx) -> dict:
        # dispfl_anneal's budgets shrink with t; dispfl's are fixed
        return evolve_counts_for(self.base.budgets_at(ctx.t, 0),
                                 ctx.prune_rate)

    def round_comm(self, state: dict, ctx: RoundCtx,
                   nnz: Optional[list[int]] = None):
        if nnz is None:
            nnz = stacked_nnz_per_client(state["masks"])
        return decentralized_comm(ctx.adjacency, nnz, self.base.n_coords)


@register_stacked("dpsgd", "dpsgd_ft")
class StackedDPSGD(StackedStrategyBase):
    """D-PSGD in stacked form: Metropolis mixing as the row-stochastic fold
    over K, unmasked local SGD, no mask search.  (``dpsgd_ft`` maps here so
    it fails with the precise unsupported-variant error, not a registry
    miss.)"""

    def validate(self, cfg) -> None:
        super().validate(cfg)
        if getattr(self.base, "param_fraction", 1.0) < 1.0:
            raise ValueError(
                "stacked dpsgd supports param_fraction=1.0 only (the shared "
                "static-mask baseline stays on RoundEngine)")
        if getattr(self.base, "finetune", False):
            raise ValueError(
                "stacked dpsgd does not implement the -FT eval variant; "
                "use RoundEngine for dpsgd_ft")

    def mix_matrix(self, ctx: RoundCtx) -> np.ndarray:
        return metropolis_weights(ctx.adjacency).astype(np.float32)

    def stacked_mix(self, state: dict, mix, full: Optional[dict] = None,
                    receivers: Optional[tuple[int, int]] = None) -> dict:
        src = state if full is None else full
        return {**state,
                "params": plain_mix_stacked(src["params"], mix,
                                            reduction=self.reduction,
                                            receivers=receivers)}

    def round_comm(self, state: dict, ctx: RoundCtx,
                   nnz: Optional[list[int]] = None):
        n = len(self.base.clients)
        return decentralized_comm(ctx.adjacency, [self.base.n_coords] * n,
                                  self.base.n_coords)
