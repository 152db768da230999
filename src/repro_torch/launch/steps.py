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
(``launch.gossip_opt``), a roll over the client dim.

``plan_for`` maps (arch x input shape x mesh) to K clients, as the
reference's does: the mesh's client capacity, one or two clients with 2-D
weights for ``FSDP2D_ARCHS``, and a single client whose KV cache is
sequence-sharded (``seq_data``) for long-context decode.  ``lower_train``,
``lower_serve`` and ``lower_for`` take the names of the reference's
lowering onto that mesh, over a ``torch.distributed`` ``DeviceMesh``: they
place params, int8 masks, batch and cache as ``DTensor``s
(``state_shardings``, the ``sharding.rules`` tree placements) and return
a ``MeshedStep`` on those ``DTensor``s.  A meshed step hands the models
each rank's local shards of the params under ``sharding.ctx.
use_mesh_rules``, as the reference traces its step under it: the models
split a client's compute over 'model' (heads, ffn hidden, vocabulary,
experts, SSM projections) and gather a weight's FSDP shard over 'data'
just before its use, with the collectives of ``sharding.tp``; no weight
is all-gathered whole over 'model'.  The gradient of a 'model'-sharded
leaf is that shard's, and the masked SGD update runs on the shard.  The
``einsum`` gossip all-gathers the K clients over the client axes only
(each rank's 'model' and FSDP shards of them), as GSPMD's einsum does in
the reference; ``ppermute`` sends ring neighbours the boundary rows only.
The batch and the serving cache reach the models as each rank's shards
too: an FSDP2D plan's rows split over 'data' (the rules then map the
logical 'batch' to 'data': ``sharding.tp.rows_split``), and the cache at
``tree_cache_shardings``' placements (head_dim over 'model'; under
``seq_data`` the sequence over 'data', by the ``kv_seq`` rule the
reference's long-context decode sets), which the models read and write
where it lies; the new cache comes back at those placements.  No input
is gathered whole.  The same step runs on real tensors in a gloo or NCCL
world and on fake tensors over a fake process group (``launch.dryrun``'s
mesh modes).
``launch.dryrun.make_plan`` stays the single-card plan (no mesh).

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.gossip_opt import ppermute_gossip
from repro_torch.models.registry import ModelAPI, meta_spec
from repro_torch.sharding import tp
from repro_torch.scale.stacked import (
    masked_gossip_stacked,
    stacked_prune_regrow_threshold,
)
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

WEIGHT_DECAY = 5e-4
GOSSIP_MODES = ("einsum", "einsum_bf16", "einsum_noopt", "ppermute", "none")
#: archs whose K=1 plan shards its weights 2-D (FSDP over 'data' + TP)
FSDP2D_ARCHS = ("jamba-1.5-large-398b",)


@dataclasses.dataclass
class ScalePlan:
    """K clients of ``arch``, each taking ``per_client_batch`` rows of
    ``shape``.  ``dtype`` types the params, the caches and the float
    inputs (prefix, frames), as in the reference (``abstract_params``,
    ``abstract_cache``, ``input_specs``).  The default is float32, where
    the reference's is bf16: the reference's default serves its TPU dry
    run, the port's callers (the ``lm`` loop, the tests, ``chip_smoke.py``'s
    fp32 phase) compute in float32, and bf16 is asked for by name
    (``plan_for`` and ``launch.dryrun`` name it by default).  ``mesh`` is
    the ``DeviceMesh`` (or a fake mesh with ``axis_names`` and a ``shape``
    dict) that ``plan_for`` planned for, None for one card; ``fsdp2d``
    (weights 2-D sharded) and ``seq_data`` (context-parallel KV cache) are
    the plan's layout over it."""
    arch: ModelConfig
    shape: InputShape
    n_clients: int
    per_client_batch: int
    dtype: torch.dtype = torch.float32
    mesh: Any = None
    fsdp2d: bool = False
    seq_data: bool = False

    @property
    def max_cache_len(self) -> int:
        return self.shape.seq_len


def plan_for(arch: ModelConfig, shape: InputShape, mesh,
             dtype: torch.dtype = torch.bfloat16) -> ScalePlan:
    """The reference's client mapping on ``mesh``: K = the mesh's client
    capacity (one client when the global batch does not split into it);
    ``FSDP2D_ARCHS`` take one client a pod; a single client shards its
    weights 2-D, and its long-context (>= 65536) decode cache by
    sequence."""
    from repro_torch.launch.mesh import client_capacity
    from repro_torch.sharding.rules import axis_names

    gb = shape.global_batch
    big = arch.name in FSDP2D_ARCHS
    if big:
        k = 2 if "pod" in axis_names(mesh) else 1
        k = min(k, gb)
    else:
        k = client_capacity(mesh)
        if gb < k or gb % k:
            k = 1                      # long_500k path: single sharded client
    fsdp2d = big or k == 1
    seq_data = shape.mode == "decode" and k == 1 and shape.seq_len >= 65536
    return ScalePlan(arch=arch, shape=shape, n_clients=k,
                     per_client_batch=gb // k, dtype=dtype, mesh=mesh,
                     fsdp2d=fsdp2d, seq_data=seq_data)


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
        shapes = api.init_cache(plan.per_client_batch, plan.max_cache_len,
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


def state_shardings(api: ModelAPI, plan: ScalePlan, mesh=None,
                    fsdp2d: bool | None = None):
    """``(params_spec, param_placements, mask_placements)``: the plan's
    stacked params as ``meta`` tensors and, per leaf, the DTensor
    placements of ``sharding.rules.param_spec`` on ``mesh`` (default: the
    plan's; masks mirror their params).  ``fsdp2d`` defaults to the plan's
    where ``plan_for`` made it, else as ``plan_for`` sets it: an
    ``FSDP2D_ARCHS`` arch, or a single client."""
    from repro_torch.sharding.rules import tree_param_shardings

    mesh = plan.mesh if mesh is None else mesh
    if fsdp2d is None:
        fsdp2d = (plan.fsdp2d if plan.mesh is not None else
                  plan.arch.name in FSDP2D_ARCHS or plan.n_clients == 1)
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
    update = masked_sgd_update(api)

    def train_step(params, masks, batch, adjacency, lr):
        if gossip == "ppermute":
            params = ppermute_gossip(params, masks, plan)
        elif _einsum_mixes(gossip, plan.n_clients):
            params = masked_gossip_stacked(params, masks, adjacency,
                                           reduction="einsum",
                                           accum_dtype=_ACCUM[gossip])
        return update(params, masks, batch, lr)

    return train_step


_ACCUM = {"einsum": torch.float32, "einsum_noopt": torch.float32,
          "einsum_bf16": torch.bfloat16}


def _einsum_mixes(gossip: str, k: int) -> bool:
    """Whether the train step mixes by einsum: not at K=1 for ``einsum`` and
    ``einsum_bf16``, where the 1x1 identity mix returns w (already
    masked); ``einsum_noopt`` keeps it."""
    return gossip in _ACCUM and (k > 1 or gossip == "einsum_noopt")


def masked_sgd_update(api: ModelAPI) -> Callable:
    """``(params, masks, batch, lr) -> (params, losses)``: each client's
    gradient on its batch, then ``w <- (w - lr (g + wd w) m) m`` in fp32,
    cast back to the leaf's dtype."""
    grads_fn = stacked_loss_grads(api)
    wd = WEIGHT_DECAY

    def update(params, masks, batch, lr):
        grads, losses = grads_fn(params, batch)
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=losses.device)

        def upd(w, g, m):
            mf, wf, gf = m.float(), w.float(), g.float()
            return ((wf - lr_t * (gf + wd * wf) * mf) * mf).to(w.dtype)

        return tree_map(upd, params, grads, masks), losses

    return update


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


# ---------------------------------------------------------------------------
# The steps over a mesh (the reference's lowering)
# ---------------------------------------------------------------------------


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def client_placements(placements) -> tuple:
    """``placements`` with only the client dim's sharding kept: every mesh
    dim that does not shard tensor dim 0 replicated."""
    return tuple(p if p == Shard(0) else Replicate() for p in placements)


def client_range(x: DTensor) -> tuple[int, int]:
    """The clients ``k0:k1`` of the stacked ``DTensor`` ``x`` this rank
    holds (all K where the client dim is not sharded).  The client axes
    divide K (``sharding.rules`` trims them until they do); DTensor splits
    over them left to right, in the mesh's order."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    k0, n = 0, x.shape[0]
    for i, p in enumerate(x.placements):
        if p == Shard(0):
            n //= mesh.size(i)
            k0 += coord[i] * n
    return k0, k0 + n


def gather_shards(x: DTensor, dims: str = "all") -> torch.Tensor:
    """``x``'s local shard all-gathered over every mesh dim that shards it
    (``dims="all"``), or only over those that shard the client dim, dim 0
    (``"clients"``), as a plain tensor: one
    ``all_gather_into_tensor`` on each such mesh dim's group,
    the last mesh dim first (DTensor splits a dim over its mesh dims left
    to right; a mesh dim of size 1 holds the whole dim).  The port's
    explicit form of ``DTensor.redistribute`` to ``Replicate`` (and of
    ``full_tensor``): c10d's all-gather is carried by NCCL, by gloo for CPU
    and CUDA tensors and by a fake process group, where the functional
    all-gather that ``redistribute`` issues crashes in its wait under
    gloo with CUDA tensors.  Shards are even (``sharding.rules`` shards a
    dim only where its mesh axes divide it)."""
    import torch.distributed as dist

    from repro_torch.utils.collectives import on_axis

    mesh, t = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if (not isinstance(p, Shard) or mesh.size(i) == 1
                or (dims == "clients" and p.dim != 0)):
            continue
        src = t.movedim(p.dim, 0).contiguous()
        out = torch.empty((mesh.size(i) * src.shape[0],) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        with on_axis(mesh.mesh_dim_names[i]):
            dist.all_gather_into_tensor(out, src, group=mesh.get_group(i))
        t = out.movedim(0, p.dim)
    return t.contiguous()


def _replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def _local(x):
    """This rank's shard of a ``DTensor`` as a plain tensor (no traffic);
    a plain tensor or number passes through."""
    return x.to_local() if isinstance(x, DTensor) else x


def _clients(x: DTensor) -> torch.Tensor:
    """The K clients of a stacked ``DTensor``, all-gathered over the client
    axes only: this rank's 'model' and FSDP shard of every client."""
    return gather_shards(x, "clients")


def _placed(local: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's shard ``local`` as a ``DTensor`` at ``like``'s
    placements (no traffic)."""
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _whole(x):
    """The whole ``DTensor`` (all-gathered over every mesh dim) as a plain
    tensor: the step's replicated arguments (adjacency, learning rate),
    whose gather moves nothing."""
    if not isinstance(x, DTensor):
        return x
    return gather_shards(x)


def _at_clients(own: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's whole clients' rows ``own`` as a ``DTensor`` split over
    ``like``'s client axes only (K leading, as ``like``'s)."""
    shape = (like.shape[0],) + tuple(own.shape[1:])
    return DTensor.from_local(own, like.device_mesh,
                              client_placements(like.placements),
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _gathered(own: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's clients' part of an output, all-gathered over the
    client axes into the whole (K, ...) output, replicated (the reference's
    ``P()`` out-sharding for losses, logits and tokens)."""
    mesh = like.device_mesh
    return DTensor.from_local(gather_shards(_at_clients(own, like)), mesh,
                              _replicated(mesh), run_check=False)


def _rules(plan: ScalePlan, b_sh) -> dict:
    """The overrides of a step's mesh rules: 'batch' on 'data' where the
    batch's placements split its rows there (an FSDP2D plan's rows,
    ``batch_spec``), and the reference's ``kv_seq`` on 'data' under
    ``plan.seq_data``."""
    data = plan.mesh.mesh_dim_names.index("data")
    rows = any(pl[data] == Shard(1) for pl in tree_leaves(
        b_sh, is_leaf=lambda x: isinstance(x, tuple)))
    if rows and plan.seq_data:
        raise ValueError("a batch split over 'data' and a sequence split "
                         "over 'data' in one step")
    return {**({"batch": ("data",)} if rows else {}),
            **({"kv_seq": ("data",)} if plan.seq_data else {})}


@dataclasses.dataclass
class MeshedStep:
    """A step of ``plan`` placed on ``plan.mesh`` (the reference's
    ``Lowered``).  ``fn`` takes ``DTensor`` arguments at ``placements``
    and returns ``DTensor``s; ``args`` are the arguments' global shapes and
    dtypes as ``meta`` tensors (a train step's learning rate a 0-d float32
    one).  ``place`` distributes real arguments, the same global tensors on
    every rank, each rank keeping its shard (no collective);
    ``abstract_args`` makes ``DTensor``s over empty local shards (fake
    ones under ``FakeTensorMode``: the dry run)."""
    plan: ScalePlan
    mode: str
    fn: Callable
    args: tuple
    placements: tuple

    def __call__(self, *args):
        return self.fn(*args)

    def place(self, *args) -> tuple:
        from torch.distributed.tensor import distribute_tensor

        mesh = self.plan.mesh

        def one(x, pl):
            if not isinstance(x, torch.Tensor):
                return x
            # every rank holds the global tensor: each keeps its own
            # shard, and nothing travels
            return distribute_tensor(x, mesh, pl, src_data_rank=None)

        return tuple(tree_map(one, a, pl)
                     for a, pl in zip(args, self.placements))

    def abstract_args(self, device) -> tuple:
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        mesh = self.plan.mesh

        def one(spec, pl):
            local, _ = compute_local_shape_and_global_offset(
                tuple(spec.shape), mesh, pl, skip_offset=True)
            return DTensor.from_local(
                torch.empty(local, dtype=spec.dtype, device=device), mesh,
                pl, run_check=False, shape=spec.shape,
                stride=_contiguous_stride(spec.shape))

        return tuple(tree_map(one, a, pl)
                     for a, pl in zip(self.args, self.placements))


def lower_train(api: ModelAPI, plan: ScalePlan,
                gossip: str = "einsum") -> MeshedStep:
    """The train step over ``plan.mesh``: params and masks at
    ``state_shardings``' placements, the batch at ``tree_batch_shardings``',
    adjacency and learning rate replicated; returns the params at their
    placements and the K losses replicated.  ``ppermute`` runs the sharded
    ring on the placed leaves; an ``einsum`` mix all-gathers the K clients'
    shards of params and masks over the client axes and mixes this rank's
    receivers.  The masked SGD step then runs on this rank's shards and
    batch rows, the models splitting each client over 'model' and an
    FSDP2D plan's rows over 'data' (``sharding.tp``)."""
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"gossip must be one of {GOSSIP_MODES}, got "
                         f"{gossip!r}")
    from repro_torch.sharding.ctx import use_mesh_rules
    from repro_torch.sharding.rules import tree_batch_shardings

    mesh = plan.mesh
    params_spec, p_sh, m_sh = state_shardings(api, plan)
    batch_spec = input_specs(api, plan)
    b_sh = tree_batch_shardings(batch_spec, mesh, plan.fsdp2d)
    rules = _rules(plan, b_sh)
    repl = _replicated(mesh)
    update = masked_sgd_update(api)
    mixes = _einsum_mixes(gossip, plan.n_clients)

    def train_step(params, masks, batch, adjacency, lr):
        first = tree_leaves(params)[0]
        if gossip == "ppermute":
            params = ppermute_gossip(params, masks, plan)
        own_m = tree_map(_local, masks)
        if mixes:
            own_p = masked_gossip_stacked(
                tree_map(_clients, params), tree_map(_clients, masks),
                _whole(adjacency), reduction="einsum",
                accum_dtype=_ACCUM[gossip], receivers=client_range(first))
        else:
            own_p = tree_map(_local, params)
        with use_mesh_rules(mesh, rules):
            new, losses = update(own_p, own_m, tree_map(_local, batch),
                                 _whole(lr))
        return tree_map(_placed, new, params), _gathered(losses, first)

    args = (params_spec, abstract_masks(params_spec), batch_spec,
            adjacency_spec(plan), meta_spec((), torch.float32))
    return MeshedStep(plan, "train", train_step, args,
                      (p_sh, m_sh, b_sh, repl, repl))


def lower_serve(api: ModelAPI, plan: ScalePlan) -> MeshedStep:
    """The prefill or decode step over ``plan.mesh``: params at
    ``state_shardings``' placements, batch and cache at
    ``tree_batch_shardings``' and ``tree_cache_shardings``' (the cache's
    sequence over 'data' where ``plan.seq_data``); returns the logits
    (prefill) or next tokens (decode) replicated and the cache at its
    placements.  The models split each client over 'model' on this rank's
    shards of the params and an FSDP2D plan's rows over 'data', and read
    and write this rank's shards of the cache (``sharding.tp``): the new
    cache is this rank's shard, at its placements."""
    from repro_torch.sharding.ctx import use_mesh_rules
    from repro_torch.sharding.rules import (
        tree_batch_shardings,
        tree_cache_shardings,
    )

    mesh = plan.mesh
    params_spec, p_sh, _ = state_shardings(api, plan)
    cache_spec = abstract_cache(api, plan)
    c_sh = tree_cache_shardings(cache_spec, mesh, plan.seq_data,
                                fsdp2d=plan.fsdp2d)
    batch_spec = input_specs(api, plan)
    b_sh = tree_batch_shardings(batch_spec, mesh, plan.fsdp2d)
    rules = _rules(plan, b_sh)
    mode = plan.shape.mode
    inner = (make_prefill_step if mode == "prefill" else
             make_decode_step)(api, plan)

    def serve_step(params, batch, cache):
        with use_mesh_rules(mesh, rules):
            out, new_cache = inner(tree_map(_local, params),
                                   tree_map(_local, batch),
                                   tree_map(_local, cache))
            # every row's logits or tokens (the rows after the client dim)
            out = tp.all_rows(out, dim=1)
        return (_gathered(out, tree_leaves(params)[0]),
                tree_map(_placed, new_cache, cache))

    return MeshedStep(plan, mode, serve_step,
                      (params_spec, batch_spec, cache_spec),
                      (p_sh, b_sh, c_sh))


def lower_for(arch: ModelConfig, shape: InputShape, mesh,
              gossip: str = "einsum", dtype: torch.dtype = torch.bfloat16,
              remat: bool = True, remat_policy: str = "full"):
    """``(plan, step)``: ``plan_for``'s plan and its train step (train
    shapes) or serve step (prefill and decode shapes) over ``mesh``, the
    models bound with ``remat`` under ``remat_policy`` (``models.remat``:
    the train step's backward recomputes each block, its ``sharding.tp``
    collectives included).  The reference's ``unroll`` has no counterpart
    in the port's eager steps."""
    from repro_torch.models.registry import bind

    plan = plan_for(arch, shape, mesh, dtype)
    api = bind(arch, remat=remat, remat_policy=remat_policy)
    if shape.mode == "train":
        return plan, lower_train(api, plan, gossip)
    return plan, lower_serve(api, plan)
