"""Parameter / cache / batch sharding rules for the production meshes
(reference ``repro.sharding.rules``), over a ``torch.distributed``
``DeviceMesh``.

Layout summary, the reference's:

* Stacked-client dim (K>1): sharded over ('pod','data') / ('data',).
* Tensor-parallel 'model' axis on: qkv out dim, o-proj in dim, ffn hidden,
  vocab, expert dim, ssm inner projections, cache head_dim.
* K==1 giants (jamba) additionally shard the non-'model' matrix dim over
  'data' (2-D FSDP+TP); the client dim (size 1, or 'pod' on the 2-pod mesh)
  still leads every leaf so the step function is uniform across archs.
* KV caches shard head_dim over 'model' (always divisible: 64/128/256);
  long-context K==1 decode additionally shards cache seq over 'data'
  (context parallelism).

The spec functions are the reference's, line for line, over a mesh's axis
names and sizes: they take a ``DeviceMesh`` (``mesh_dim_names``, ``shape``)
or any object with the reference's ``axis_names`` and a ``shape`` dict (the
tests' fake meshes).  They return a ``PartitionSpec``, a tuple whose
entries are normalised as jax 0.9's: a 1-tuple of axes reads back as the
axis name, an empty tuple as ``None``.  The ``tree_*_shardings`` functions
return, per leaf, the DTensor placements of that spec on the mesh: one
``Shard(dim)`` or ``Replicate()`` per mesh dim, in the mesh's order.  A
tensor dim on ('pod','data') is ``Shard(0)`` on both mesh dims; DTensor
splits left to right, pod first, so client ``k`` lands on the pod-major
rank, as in jax.
"""
from __future__ import annotations

import math
from typing import Any, Optional

from torch.distributed.tensor import Replicate, Shard

from repro_torch.utils.tree import tree_map, tree_map_with_path

PyTree = Any

# path fragments whose 2-D matrices are (sharded_in, out) rather than
# (in, sharded_out)
_ROW_SHARDED = ("wo/w", "w_down", "out_proj", "head/w")
_REPLICATED = ("norm", "gn", "A_log", "/D", "dt_bias", "enc_pos", "router",
               "conv_b")


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple
    of axis names (the dim split over them, the first the major one).  A
    1-tuple is stored as its axis and an empty tuple as ``None``, as jax
    0.9's ``PartitionSpec`` stores them."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p

        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or a
    fake mesh's ``axis_names``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size (a ``DeviceMesh``'s ``shape`` is a tuple in its
    dims' order, a fake mesh's a dict)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def _is_replicated(path: str) -> bool:
    return any(k in path for k in _REPLICATED) or path.endswith("/b")


def _client_axes(mesh, fsdp2d: bool = False,
                 k: Optional[int] = None) -> Optional[tuple]:
    """Mesh axes carrying the stacked client dim.  FSDP2D archs put clients
    on 'pod' only ('data' is the FSDP axis); on a single-pod mesh their
    client dim has size 1 and stays unsharded.  When ``k`` (the actual
    leading-dim size) is given, the axes are trimmed until they divide it
    (K=1 long-context decode on the multi-pod mesh stays unsharded)."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    if fsdp2d:
        axes = ("pod",) if "pod" in names else None
    else:
        axes = ("pod", "data") if "pod" in names else ("data",)
    if axes is None or k is None:
        return axes
    while axes:
        size = math.prod(sizes[a] for a in axes)
        if k >= size and k % size == 0:
            return axes
        axes = axes[:-1]
    return None


def _fits(dim: int, mesh, axis: str) -> bool:
    size = axis_sizes(mesh)[axis]
    return dim % size == 0 and dim >= size


def param_spec(path: str, shape: tuple, mesh, fsdp2d: bool,
               stacked: bool = True) -> PartitionSpec:
    """PartitionSpec for one (client-stacked) parameter leaf."""
    client = _client_axes(mesh, fsdp2d, shape[0] if stacked else None)
    body = shape[1:] if stacked else shape
    lead = [client if stacked else None]
    fsdp = "data" if fsdp2d else None

    def dims() -> list:
        d = len(body)
        # vectors / norms / biases / routers / conv params stay replicated
        if _is_replicated(path) or d <= 1:
            return [None] * d
        # stacked scan-block leaves have a leading n_blocks dim
        if "/moe/" in path and "shared" not in path and d >= 3:
            # (blocks?, E, d1, d2): expert dim over model, d1 over fsdp
            pre = [None] * (d - 3)
            e_ok = _fits(body[d - 3], mesh, "model")
            return pre + ["model" if e_ok else None,
                          fsdp if fsdp and _fits(body[d - 2], mesh, "data")
                          else None,
                          None]
        if "embed/table" in path:
            return [("model" if _fits(body[0], mesh, "model") else None),
                    (fsdp if fsdp and _fits(body[1], mesh, "data") else None)]
        pre = [None] * (d - 2)
        r, c = body[-2], body[-1]
        if any(k in path for k in _ROW_SHARDED):
            return pre + [("model" if _fits(r, mesh, "model") else None),
                          (fsdp if fsdp and _fits(c, mesh, "data") else None)]
        if "conv_w" in path:
            return pre + [None, ("model" if _fits(c, mesh, "model") else None)]
        return pre + [(fsdp if fsdp and _fits(r, mesh, "data") else None),
                      ("model" if _fits(c, mesh, "model") else None)]

    spec = (lead + dims()) if stacked else dims()
    return P(*spec)


def cache_spec(path: str, shape: tuple, mesh, seq_data: bool,
               stacked: bool = True, fsdp2d: bool = False) -> PartitionSpec:
    """KV/SSM cache leaves.  shape (K, [blocks,] B, S, h, dh) for kv,
    (K, [blocks,] B, H, Pd, N) for ssm_state, (K, [blocks,] B, W, C) conv."""
    client = _client_axes(mesh, fsdp2d, shape[0] if stacked else None)
    body = list(shape[1:] if stacked else shape)
    d = len(body)
    lead = [client if stacked else None]

    def dims() -> list:
        if path.endswith("/k") or path.endswith("/v"):
            pre = [None] * (d - 4)
            seq = "data" if seq_data else None
            dh = "model" if _fits(body[-1], mesh, "model") else None
            return pre + [None, seq, None, dh]
        if "ssm_state" in path:
            pre = [None] * (d - 4)
            h = "model" if _fits(body[-3], mesh, "model") else None
            return pre + [None, h, None, None]
        if "conv_state" in path:
            pre = [None] * (d - 3)
            c = "model" if _fits(body[-1], mesh, "model") else None
            return pre + [None, None, c]
        return [None] * d

    spec = (lead + dims()) if stacked else dims()
    return P(*spec)


def batch_spec(path: str, shape: tuple, mesh,
               fsdp2d: bool = False) -> PartitionSpec:
    """Stacked input leaves (K, B, ...): client dim over its axes; for
    FSDP2D archs the per-client batch dim rides 'data' when divisible."""
    client = _client_axes(mesh, fsdp2d, shape[0])
    rest = [None] * (len(shape) - 1)
    data = axis_sizes(mesh)["data"]
    if fsdp2d and len(shape) >= 2 and shape[1] % data == 0 \
            and shape[1] >= data:
        rest[0] = "data"
    return P(*([client] + rest))


def stacked_spec(shape: tuple, mesh, fsdp2d: bool = False) -> PartitionSpec:
    """Client-dim-only PartitionSpec for a stacked (K-leading) leaf.

    This is the layout of ``repro_torch.scale`` state and batches: the
    leading K dim rides the client axes (trimmed until they divide K),
    every other dim stays unsharded — per-client tensors are small; it is
    the *count* of clients that scales.  Contrast ``param_spec``, which
    additionally TP/FSDP-shards the body dims for the giant-arch plans."""
    client = _client_axes(mesh, fsdp2d, shape[0] if shape else None)
    return P(*([client] + [None] * (len(shape) - 1)))


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim, in its
    order, ``Shard(d)`` for the tensor dim ``d`` whose entry names that
    axis, else ``Replicate()``.  An entry naming several axes must name
    them in the mesh's order (DTensor splits left to right)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} splits over {axes}, not in "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards "
                                 "two tensor dims")
            out[i] = Shard(d)
    return tuple(out)


def stacked_sharding(shape: tuple, mesh, fsdp2d: bool = False) -> tuple:
    return placements(stacked_spec(shape, mesh, fsdp2d), mesh)


def tree_stacked_shardings(tree: PyTree, mesh, fsdp2d: bool = False) -> PyTree:
    """Placements for a whole stacked state pytree (params/masks/opt-state
    with a leading K dim) — the ``repro_torch.scale`` engine's layout."""
    return tree_map(
        lambda x: stacked_sharding(tuple(x.shape), mesh, fsdp2d), tree)


def tree_param_shardings(tree: PyTree, mesh, fsdp2d: bool,
                         stacked: bool = True) -> PyTree:
    return tree_map_with_path(
        lambda p, x: placements(param_spec(p, tuple(x.shape), mesh, fsdp2d,
                                           stacked), mesh), tree)


def tree_cache_shardings(tree: PyTree, mesh, seq_data: bool,
                         stacked: bool = True, fsdp2d: bool = False) -> PyTree:
    return tree_map_with_path(
        lambda p, x: placements(cache_spec(p, tuple(x.shape), mesh, seq_data,
                                           stacked, fsdp2d), mesh), tree)


def tree_batch_shardings(tree: PyTree, mesh, fsdp2d: bool = False) -> PyTree:
    return tree_map_with_path(
        lambda p, x: placements(
            batch_spec(p, tuple(x.shape), mesh, fsdp2d)
            if len(x.shape) > 0 else P(), mesh),
        tree)
