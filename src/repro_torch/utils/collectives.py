"""Collective traffic of one rank, counted from the ops it dispatches: the
port's counterpart of ``repro.utils.hlo``, which reads the collectives out
of XLA's partitioned HLO.  The port has no HLO; its meshed steps issue
``torch.distributed`` collectives eagerly (a ``DTensor`` redistribution,
the ring gossip's sends), and each one passes the dispatcher as a
``c10d`` op or a functional-collective (``_c10d_functional``) op.
``collective_bytes(fn, *args)`` runs ``fn`` once under
``CollectiveCounter``, a ``TorchDispatchMode`` that books those ops, on
real tensors or on fake ones (a fake process group, the dry run).

Per-op byte conventions, the reference's (ring algorithms, bytes per
device), under the reference's kind names:

  all-gather        : output bytes (each device receives ~full output)
  all-reduce        : 2 x input bytes (reduce-scatter + all-gather phases)
  reduce-scatter    : input bytes
  all-to-all        : input bytes
  collective-permute: input bytes (one neighbour send/recv)

Each booked op is also logged in ``CollectiveStats.ops`` as ``(kind,
mesh axis, shape)``: the axis its caller named (``on_axis``; None where
none did, as for the ring's client axes) and the shape of the booked
tensor (an all-gather's output).  A point-to-point send is a
``collective-permute``; its receive is the same bytes arriving and is not
booked again.  Code may book its ops under
another kind (``booked_as``): the ring gossip's ``all_to_all_single``,
whose splits reach only ring neighbours, is a ``collective-permute``.
``broadcast`` and ``scatter`` (placing a tensor from one rank) keep their
own names and book their input bytes.  ``wait_tensor`` and other bookkeeping
ops move nothing.  The aten-op histogram (the reference's ``op_histogram``)
is ``utils.trace_cost``'s.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.utils.trace_cost import COLLECTIVE_NAMESPACES as NAMESPACES

# op name -> (kind, the argument whose bytes are booked: its input for the
# in-bytes kinds, its output buffer for all-gather; None: the op's result)
_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", None),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.broadcast_": ("broadcast", 0),
    "c10d.scatter_": ("scatter", 1),
}
_FACTOR = {"all-reduce": 2.0}
#: c10d ops that move no bytes of their own (a receive mirrors a send)
_UNBOOKED = ("c10d.recv_", "c10d.recv_any_source_", "c10d.barrier",
             "c10d.monitored_barrier_", "_c10d_functional.wait_tensor")


_booking = threading.local()


@contextlib.contextmanager
def booked_as(kind: str):
    """Inside it, a counter books every collective under ``kind``."""
    prev = getattr(_booking, "kind", None)
    _booking.kind = kind
    try:
        yield
    finally:
        _booking.kind = prev


@contextlib.contextmanager
def on_axis(name: str):
    """Inside it, a counter logs every collective as one over the mesh
    axis ``name``."""
    prev = getattr(_booking, "axis", None)
    _booking.axis = name
    try:
        yield
    finally:
        _booking.axis = prev


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    ops: list = field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def row(self) -> dict:
        return {
            "total_GB": round(self.total_bytes / 1e9, 4),
            **{k: round(v / 1e9, 4)
               for k, v in sorted(self.bytes_by_kind.items())},
            "counts": dict(sorted(self.count_by_kind.items())),
        }

    def book(self, kind: str, nbytes: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


class CollectiveCounter(TorchDispatchMode):
    """Books every collective op dispatched while the mode is active into
    ``stats``; an op of the collective namespaces that it does not know
    raises, so no traffic goes uncounted."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace not in NAMESPACES:
            return out
        name = f"{func.namespace}.{func._opname}"
        if name in _UNBOOKED or name.startswith("_c10d_functional._"):
            return out
        if name not in _OPS:
            raise NotImplementedError(f"collective op {name} has no byte "
                                      "convention in utils.collectives")
        kind, arg = _OPS[name]
        kind = getattr(_booking, "kind", None) or kind
        booked = out if arg is None else args[arg]
        self.stats.book(kind, _nbytes(booked) * _FACTOR.get(kind, 1.0))
        self.stats.ops.append((kind, getattr(_booking, "axis", None),
                               tuple(_first(booked).shape)))
        return out


def _first(tree) -> torch.Tensor:
    return next(t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor))


def collective_bytes(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once under ``CollectiveCounter``; returns
    ``(out, CollectiveStats)``: the collective traffic this rank
    dispatched, per kind, by the reference's conventions."""
    counter = CollectiveCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
