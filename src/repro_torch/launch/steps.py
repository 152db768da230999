"""Step builders for stacked-client DisPFL training and personalized serving
of the LM families (reference ``repro.launch.steps``).

The whole decentralized system is one program over client-stacked state:
client models carry a leading K dim, the intersection gossip is an
adjacency einsum over that dim (``scale.stacked.masked_gossip_stacked``),
and the local masked-SGD step, the mask search's dense gradient, the
prefill and the decode are ``torch.func.vmap`` over clients.

``make_mask_update_step`` picks thresholds with ``torch.sort`` and applies
them with the prune/regrow kernel (``kernels.prune_regrow``), one launch
per sparsifiable leaf on the GPU, on the leaf's own dtype.  Every step
runs on float32 or bf16 state (``ScalePlan.dtype``) with int8 masks; bf16
params take SGD's update in fp32 and are cast back, as in the
reference.  ``gossip="ppermute"`` is the reference's ring gossip
(``launch.gossip_opt``), a roll over the client dim.  The reference's
``plan_for`` and ``lower_*`` lower these steps onto a TPU mesh; the port
plans K clients on one card (``launch.dryrun.make_plan``) and traces the
steps on fake tensors in place of lowering them, so a ``ScalePlan``
carries no mesh.  ``state_shardings`` gives, over a ``DeviceMesh`` the
caller names, the placements the reference's layout puts each stacked
leaf at (``sharding.rules``: client axes, tensor-parallel 'model',
FSDP 'data' for ``FSDP2D_ARCHS``), and ``adjacency_spec`` the round's
(K, K) input; nothing is lowered or distributed with them yet.

The steps are plain functions, as the reference's are; a caller compiles
one with ``utils.graph.graphed`` (the reference's callers ``jax.jit``
them).  Every per-call value may be a tensor on the state's device (the
learning rate, the prune rate, the decode positions, the adjacency), so
a captured step replays with new values; Python numbers and arrays work
eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.gossip_opt import ppermute_gossip
from repro_torch.models.registry import ModelAPI, meta_spec
from repro_torch.scale.stacked import (
    masked_gossip_stacked,
    stacked_prune_regrow_threshold,
)
from repro_torch.utils.tree import tree_map

PyTree = Any

WEIGHT_DECAY = 5e-4
GOSSIP_MODES = ("einsum", "einsum_bf16", "einsum_noopt", "ppermute", "none")
#: archs whose K=1 plan shards its weights 2-D (FSDP over 'data' + TP)
FSDP2D_ARCHS = ("jamba-1.5-large-398b",)


@dataclasses.dataclass
class ScalePlan:
    """K clients of ``arch`` on one card, each taking ``per_client_batch``
    rows of ``shape``.  ``dtype`` types the params, the caches and the
    float inputs (prefix, frames), as in the reference
    (``abstract_params``, ``abstract_cache``, ``input_specs``).  The
    default is float32, where the reference's is bf16: the reference's
    default serves its TPU dry run, the port's callers (the ``lm`` loop,
    the tests, ``chip_smoke.py``'s fp32 phase) compute in float32, and
    bf16 is asked for by name (``launch.dryrun`` names it by default)."""
    arch: ModelConfig
    shape: InputShape
    n_clients: int
    per_client_batch: int
    dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# Abstract state: tensors on the ``meta`` device (shapes and dtypes only)
# ---------------------------------------------------------------------------


def _stack_specs(tree: PyTree, k: int) -> PyTree:
    return tree_map(lambda s: meta_spec((k,) + tuple(s.shape), s.dtype), tree)


def abstract_params(api: ModelAPI, plan: ScalePlan) -> PyTree:
    """The stacked (K, ...) params of ``plan.dtype`` as ``meta`` tensors,
    the port's ``jax.eval_shape`` of the reference's: ``api.init`` runs
    under ``FakeTensorMode``, so no weight is drawn or stored."""
    with FakeTensorMode():
        shapes = api.init(torch.Generator(), plan.dtype)
    return _stack_specs(shapes, plan.n_clients)


def abstract_cache(api: ModelAPI, plan: ScalePlan) -> PyTree:
    """The stacked (K, ...) caches of ``plan.dtype`` for the plan's
    per-client batch and ``shape.seq_len`` slots, as ``meta`` tensors."""
    with FakeTensorMode():
        shapes = api.init_cache(plan.per_client_batch, plan.shape.seq_len,
                                plan.dtype)
    return _stack_specs(shapes, plan.n_clients)


def abstract_masks(params_spec: PyTree) -> PyTree:
    """Masks stored as int8 (w ⊙ m casts at use sites)."""
    return tree_map(lambda s: meta_spec(s.shape, torch.int8), params_spec)


def input_specs(api: ModelAPI, plan: ScalePlan) -> PyTree:
    """Stacked (K, ...) batch specs for the plan's shape."""
    per = api.input_specs(plan.shape, plan.dtype, batch=plan.per_client_batch)
    stacked = _stack_specs(per, plan.n_clients)
    if plan.shape.mode == "decode":
        stacked["pos"] = meta_spec((plan.n_clients,), torch.int32)
    return stacked


def adjacency_spec(plan: ScalePlan) -> torch.Tensor:
    """The round's (K, K) float32 adjacency as a ``meta`` tensor."""
    return meta_spec((plan.n_clients, plan.n_clients), torch.float32)


def state_shardings(api: ModelAPI, plan: ScalePlan, mesh,
                    fsdp2d: bool | None = None):
    """``(params_spec, param_placements, mask_placements)``: the plan's
    stacked params as ``meta`` tensors and, per leaf, the DTensor
    placements of ``sharding.rules.param_spec`` on ``mesh`` (masks mirror
    their params).  ``fsdp2d`` defaults as the reference's ``plan_for``
    sets it: an ``FSDP2D_ARCHS`` arch, or a single client."""
    from repro_torch.sharding.rules import tree_param_shardings

    if fsdp2d is None:
        fsdp2d = plan.arch.name in FSDP2D_ARCHS or plan.n_clients == 1
    params_spec = abstract_params(api, plan)
    p_sh = tree_param_shardings(params_spec, mesh, fsdp2d)
    return params_spec, p_sh, p_sh


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def stacked_loss_grads(api: ModelAPI) -> Callable:
    """``(params, batch) -> (grads, losses)``: each client's ``train_loss``
    on its own batch (vmapped), and the gradient of their sum — per client,
    the gradient of its own loss."""

    def total_loss(params, batch):
        losses = torch.func.vmap(lambda p, b: api.train_loss(p, b)[0])(
            params, batch)
        return torch.sum(losses), losses

    return torch.func.grad(total_loss, has_aux=True)


def make_train_step(api: ModelAPI, plan: ScalePlan, gossip: str = "einsum"):
    """One DisPFL round step: intersection gossip + one masked-SGD step
    with weight decay, ``w <- (w - lr (g + wd w) m) m``.

    gossip: ``'einsum'`` (adjacency einsums over the client dim, fp32),
    ``'einsum_bf16'`` (the same, accumulated in bfloat16), ``'einsum_noopt'``
    (``'einsum'`` without its K=1 skip, where the 1x1 identity mix is a
    no-op), ``'ppermute'`` (the ring gossip of ``launch.gossip_opt``,
    ±1 neighbours; the adjacency is not read) or ``'none'`` (no gossip).
    """
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"gossip must be one of {GOSSIP_MODES}, got "
                         f"{gossip!r}")
    grads_fn = stacked_loss_grads(api)
    wd = WEIGHT_DECAY

    def train_step(params, masks, batch, adjacency, lr):
        if gossip in ("einsum", "einsum_bf16") and plan.n_clients == 1:
            pass    # the 1x1 identity mix returns w (already masked)
        elif gossip == "ppermute":
            params = ppermute_gossip(params, masks, plan)
        elif gossip != "none":
            acc = torch.bfloat16 if gossip == "einsum_bf16" else torch.float32
            params = masked_gossip_stacked(params, masks, adjacency,
                                           reduction="einsum",
                                           accum_dtype=acc)
        grads, losses = grads_fn(params, batch)
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=losses.device)

        def upd(w, g, m):
            mf, wf, gf = m.float(), w.float(), g.float()
            return ((wf - lr_t * (gf + wd * wf) * mf) * mf).to(w.dtype)

        return tree_map(upd, params, grads, masks), losses

    return train_step


def make_mask_update_step(api: ModelAPI, plan: ScalePlan,
                          density: float = 0.5):
    """Once-per-round mask search (Alg. 2) for every client at once: the
    dense gradient on one batch, then ``stacked_prune_regrow_threshold``
    (kth order statistics by sort, then the prune/regrow kernel once per
    sparsifiable leaf).  Layer budgets are static (``density`` x numel);
    ``prune_rate`` may be a float32 device tensor.  Returns ``(params,
    masks)``."""
    dense_grads = torch.func.vmap(
        torch.func.grad(lambda p, b: api.train_loss(p, b)[0]))

    def mask_update(params, masks, batch, prune_rate):
        grads = dense_grads(params, batch)
        new_masks, new_params = stacked_prune_regrow_threshold(
            params, masks, grads, prune_rate, density)
        return new_params, new_masks

    return mask_update


def make_prefill_step(api: ModelAPI, plan: ScalePlan):
    def prefill_step(params, batch, cache):
        return torch.func.vmap(api.prefill)(params, batch, cache)

    return prefill_step


def make_decode_step(api: ModelAPI, plan: ScalePlan):
    """Greedy decode of one token per row: ``batch = {'tokens': (K, B, 1),
    'pos': (K,)}`` -> (next tokens (K, B) int32, cache)."""

    def decode_step(params, batch, cache):
        logits, cache = torch.func.vmap(api.decode)(
            params, batch["tokens"], batch["pos"], cache)
        next_tok = torch.argmax(logits[..., -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
