"""Tensor-parallel, FSDP and context-parallel collectives as
differentiable, vmappable ops on plain local tensors: the port's
hand-written form of what GSPMD inserts into the reference's meshed steps
(``repro.launch.steps.lower_*`` traced under ``use_mesh_rules``).

A meshed LM step (``launch.steps.lower_train`` / ``lower_serve``) hands the
models each rank's local shards of the params, the batch and the cache,
under ``sharding.ctx.use_mesh_rules``.  The models then split a client's
compute over the mesh axis 'model' with Megatron's pairs, gather a
weight's FSDP shard over 'data' just before its use (``whole``), and move
activations between layouts with an all-to-all:

  copy_to(x, axis)           identity forward, all-reduce backward
  reduce_from(x, axis)       all-reduce forward, identity backward
  gather_from(x, axis, dim)  all-gather along ``dim`` forward, own slice
                             backward
  split_to(x, axis, dim)     own slice forward, all-gather backward
  all_to_all(x, axis, split_dim, cat_dim)
                             ``x`` cut along ``split_dim`` into one piece
                             a rank, piece j sent to rank j, the pieces
                             received joined along ``cat_dim`` in rank
                             order; backward, the same op with the dims
                             swapped
  whole(w, dim, full)        an FSDP shard all-gathered over 'data'
                             forward; backward, its gradient
                             reduce-scattered where the compute is split
                             over 'data' (a pair: reduce-scatter forward,
                             all-gather backward), else the own slice

Each is a ``torch.autograd.Function`` in the ``setup_context`` style with
an explicit ``vmap`` rule: the rule moves the batch dim to the front and
runs the same collective once on the whole physical tensor, so the ops run
inside the steps' ``torch.func.vmap`` over clients and ``torch.func.grad``
in either order.  A backward calls its pair's ``apply`` (never c10d
directly), so a backward that runs under ``vmap`` is batched by the same
rule.  The mesh axis is resolved when an op is applied (``_Axis``: its
group, size and this rank's place) and carried to the backward, which on
the GPU runs on autograd's device thread, outside the caller's
``use_mesh_rules``.  The collectives are c10d ops on the mesh dim's group
(``mesh.get_group(i)``), as ``launch.steps.gather_shards`` issues them:
``all_reduce`` (SUM), ``all_gather_into_tensor``, ``reduce_scatter`` and
``all_to_all_single``, which NCCL, gloo (CPU and CUDA tensors) and a fake
process group carry, and which ``utils.collectives`` books as all-reduce,
all-gather, reduce-scatter and all-to-all.

Outside a ``use_mesh_rules`` context, and on a mesh axis of size 1, every
op returns its input and dispatches nothing.

Where |model| does not divide the dim an op would split (gemma3-1b's 4
heads on a 'model' of 16), that op computes replicated over 'model': a
stated rule of the models, not a fallback.  They name each such op with
``replicated``; ``record_replicated`` collects the names (the dry run's
``replicated`` field).

The batch split over 'data'.  Where an FSDP2D plan's batch rows are
split over 'data' (``batch_spec``), the step maps the logical 'batch' to
'data' (``rows_split``), and each rank computes its own rows.  **A
weight's gradient is summed over 'data' exactly where the compute that
reads it is split over 'data'**: an FSDP weight read there is gathered
by ``whole`` with its gradient reduce-scattered, and a leaf every
'data' rank holds whole enters through ``copy_to(w, "data")``
(``shared``: norm scales, biases, the SSM's vectors, dims 'data' does
not divide).  Compute that needs the client's whole batch (the MoE's
routing, dispatch and combine) runs on rows gathered over 'data',
repeated on every 'data' rank: a weight read only there (the router)
takes no collective, its whole gradient already on every rank.  The loss
is the client's mean: the rank's sum all-reduced over 'data' over the
client's count.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from repro_torch.sharding import ctx
from repro_torch.sharding.rules import axis_sizes
from repro_torch.utils.collectives import on_axis


def axis_size(axis: str) -> int:
    """The size of ``axis`` on the context's mesh; 1 outside a context or
    where the mesh has no such axis."""
    mesh = ctx.current_mesh()
    return 1 if mesh is None else axis_sizes(mesh).get(axis, 1)


_notes = threading.local()


@contextlib.contextmanager
def record_replicated():
    """Inside it, the names of the ops the models compute replicated over
    a mesh axis of more than one rank are added to the set it yields."""
    prev = getattr(_notes, "ops", None)
    _notes.ops = set()
    try:
        yield _notes.ops
    finally:
        _notes.ops = prev


def replicated(op: str, axis: str = "model") -> None:
    """Notes that ``op`` computes replicated over ``axis`` where that axis
    has more than one rank (|model| does not divide the dim it would
    split)."""
    ops = getattr(_notes, "ops", None)
    if ops is not None and axis_size(axis) > 1:
        ops.add(op)


def axis_rank(axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 outside a context)."""
    return _axis(axis).rank


class _Axis(NamedTuple):
    """A mesh axis as an op carries it: its name, process group, size and
    this rank's coordinate."""
    name: str
    group: object
    size: int
    rank: int


def _axis(axis: str) -> _Axis:
    mesh = ctx.current_mesh()
    size = axis_size(axis)
    if size == 1:
        return _Axis(axis, None, 1, 0)
    i = mesh.mesh_dim_names.index(axis)
    return _Axis(axis, mesh.get_group(i), size, mesh.get_local_rank(i))


def _all_reduce(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    with on_axis(ax.name):
        dist.all_reduce(out, group=ax.group)
    return out


def _all_gather(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((ax.size * src.shape[0],) + src.shape[1:],
                      dtype=src.dtype, device=src.device)
    with on_axis(ax.name):
        dist.all_gather_into_tensor(out, src, group=ax.group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // ax.size,) + src.shape[1:],
                      dtype=src.dtype, device=src.device)
    with on_axis(ax.name):
        scatter(out, src, group=ax.group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, ax: _Axis, split_dim: int,
                cat_dim: int) -> torch.Tensor:
    import torch.distributed as dist
    # piece j of ``split_dim`` leads, for rank j
    src = x.unflatten(split_dim, (ax.size, -1)).movedim(split_dim, 0)
    src = src.contiguous()
    out = torch.empty_like(src)
    with on_axis(ax.name):
        dist.all_to_all_single(out, src, group=ax.group)
    # out[j] came from rank j: joined along ``cat_dim`` in rank order
    return out.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1).contiguous()


def _rank_slice(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


def _batched(in_dim, x):
    """``x`` with its batch dim in front (unchanged where unbatched)."""
    return x if in_dim is None else x.movedim(in_dim, 0)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, ax):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax = inputs[1]

    @staticmethod
    def backward(ctx_, g):
        return _ReduceFrom.apply(g, ctx_.ax), None

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _CopyTo.apply(_batched(in_dims[0], x), ax), (
            None if in_dims[0] is None else 0)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax = inputs[1]

    @staticmethod
    def backward(ctx_, g):
        return _CopyTo.apply(g, ctx_.ax), None

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _ReduceFrom.apply(_batched(in_dims[0], x), ax), (
            None if in_dims[0] is None else 0)


def _physical_dim(in_dim, x_logical_ndim: int, dim: int) -> int:
    """A logical (non-negative or negative) ``dim`` in the physical tensor
    whose batch dim leads."""
    d = dim % x_logical_ndim
    return d if in_dim is None else d + 1


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, ax, dim):
        return _all_gather(x, ax, dim)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax, ctx_.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx_, g):
        return _SplitTo.apply(g, ctx_.ax, ctx_.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, ax, dim):
        d = _physical_dim(in_dims[0], x.dim() - (in_dims[0] is not None),
                          dim)
        return _GatherFrom.apply(_batched(in_dims[0], x), ax, d), (
            None if in_dims[0] is None else 0)


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(x, ax, dim):
        return _rank_slice(x, ax, dim)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax, ctx_.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx_, g):
        return _GatherFrom.apply(g, ctx_.ax, ctx_.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, ax, dim):
        d = _physical_dim(in_dims[0], x.dim() - (in_dims[0] is not None),
                          dim)
        return _SplitTo.apply(_batched(in_dims[0], x), ax, d), (
            None if in_dims[0] is None else 0)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(x, ax, dim):
        return _all_gather(x, ax, dim)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax, ctx_.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx_, g):
        return _ScatterSum.apply(g, ctx_.ax, ctx_.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, ax, dim):
        d = _physical_dim(in_dims[0], x.dim() - (in_dims[0] is not None),
                          dim)
        return _GatherSum.apply(_batched(in_dims[0], x), ax, d), (
            None if in_dims[0] is None else 0)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(x, ax, dim):
        return _reduce_scatter(x, ax, dim)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax, ctx_.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx_, g):
        return _GatherSum.apply(g, ctx_.ax, ctx_.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, ax, dim):
        d = _physical_dim(in_dims[0], x.dim() - (in_dims[0] is not None),
                          dim)
        return _ScatterSum.apply(_batched(in_dims[0], x), ax, d), (
            None if in_dims[0] is None else 0)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, ax, split_dim, cat_dim):
        return _all_to_all(x, ax, split_dim, cat_dim)

    @staticmethod
    def setup_context(ctx_, inputs, output):
        ctx_.ax, ctx_.dims = inputs[1], inputs[2:]

    @staticmethod
    def backward(ctx_, g):
        split_dim, cat_dim = ctx_.dims
        return _AllToAll.apply(g, ctx_.ax, cat_dim, split_dim), None, None, \
            None

    @staticmethod
    def vmap(info, in_dims, x, ax, split_dim, cat_dim):
        n = x.dim() - (in_dims[0] is not None)
        return _AllToAll.apply(
            _batched(in_dims[0], x), ax,
            _physical_dim(in_dims[0], n, split_dim),
            _physical_dim(in_dims[0], n, cat_dim)), (
            None if in_dims[0] is None else 0)


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A replicated ``x`` entering a computation split over ``axis``: the
    identity forward; backward, the sum over ``axis`` of each rank's part
    of the gradient."""
    ax = _axis(axis)
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x`` (the output of a
    row-split matmul); the gradient passes unchanged."""
    ax = _axis(axis)
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, axis: str = "model",
                dim: int = -1) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` joined in ``axis`` order;
    backward, this rank's slice of the gradient."""
    ax = _axis(axis)
    return x if ax.size == 1 else _GatherFrom.apply(x, ax, dim)


def split_to(x: torch.Tensor, axis: str = "model",
             dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim`` (even slices,
    in ``axis`` order); backward, the ranks' gradient slices joined."""
    ax = _axis(axis)
    return x if ax.size == 1 else _SplitTo.apply(x, ax, dim)


def all_to_all(x: torch.Tensor, axis: str = "model", split_dim: int = -1,
               cat_dim: int = -1) -> torch.Tensor:
    """``x`` cut along ``split_dim`` into one even piece a rank of
    ``axis``, piece j sent to rank j, and the pieces this rank receives
    joined along ``cat_dim`` in rank order; backward, the gradient sent
    back the same way."""
    ax = _axis(axis)
    if ax.size == 1:
        return x
    n = x.dim()
    return _AllToAll.apply(x, ax, split_dim % n, cat_dim % n)


def rows_split() -> bool:
    """Whether the context's compute holds this rank's rows of each
    client's batch, split over a 'data' axis of more than one rank: the
    step mapped the logical 'batch' to 'data' (``launch.steps``, an
    FSDP2D plan's rows at ``tree_batch_shardings``' placements)."""
    return "data" in ctx.rule("batch") and axis_size("data") > 1


def own_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows (along ``dim``) of ``x``, which every 'data' rank
    holds whole (a cache leaf), where ``rows_split``; else ``x``."""
    return split_to(x, "data", dim) if rows_split() else x


def all_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every 'data' rank's rows (along ``dim``) of ``x`` joined in rank
    order, where ``rows_split``; else ``x``."""
    return gather_from(x, "data", dim) if rows_split() else x


def shared(w: torch.Tensor) -> torch.Tensor:
    """``w``, a leaf every 'data' rank holds whole, as compute reads it:
    through ``copy_to(w, "data")`` where ``rows_split``, so its gradient
    sums every rank's rows; else ``w``."""
    return copy_to(w, "data") if rows_split() else w


def whole(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``w`` whole along ``dim`` (``full`` entries): its FSDP shard over
    'data' gathered just before its use where it holds one, the gradient
    reduce-scattered over 'data' where ``rows_split`` and its own slice
    taken elsewhere (the module's docstring); a ``w`` already whole is
    ``shared``."""
    if w.shape[dim] == full:
        return shared(w)
    if not rows_split():
        return gather_from(w, "data", dim)
    return _GatherSum.apply(w, _axis("data"), dim)


def split(local: int, full: int) -> bool:
    """Whether a dim of ``full`` entries is split over 'model': this rank
    holds ``local`` of them (``sharding.rules`` splits a dim only where
    |model| divides it)."""
    if local == full:
        return False
    if local * axis_size("model") != full:
        raise ValueError(f"a dim of {full} held as {local} on a 'model' "
                         f"axis of {axis_size('model')}")
    return True
