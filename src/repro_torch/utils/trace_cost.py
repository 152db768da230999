"""What one eager step costs, counted from the ops it dispatches: the
port's counterpart of ``repro.utils.hlo`` (which reads collective bytes and
an op histogram out of XLA's partitioned HLO; the port has no HLO).

``step_cost(fn, *args)`` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` and ``TraceCost``, a
``TorchDispatchMode`` that sees every aten op the step dispatches — on
fake tensors (``FakeTensorMode``, the dry run) or on real ones (the same
step on the card), with the same counts either way:

* ``bytes accessed``: over every op that is not a view or an alias, the
  bytes of its tensor inputs and outputs.  Eager PyTorch fuses nothing, so
  this is the step's unfused HBM traffic, the counterpart of XLA's
  ``bytes accessed``;
* peak live bytes: each storage is counted once when an op first returns
  it (views share it) and freed when its last tensor dies; the
  arguments' storages are live throughout;
* ``aten_ops``: a histogram of the ops counted for bytes (not views, not
  the collectives of a meshed step, which ``utils.collectives`` books);
* ``flops``: ``FlopCounterMode``'s, which counts matmul, convolution and
  attention FLOPs only (``FLOPS_COUNTED_BY``).

A counter of the port's own, rather than
``torch.distributed._tools.mem_tracker.MemTracker`` (a private API).
Storages are told apart by their Python objects, which torch keeps for
the life of the storage.  ``prim`` ops (a fake tensor's ``device`` query)
are not the step's work and are not counted.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

#: ops that move data between ranks: ``utils.collectives`` books them, and
#: their buffers are not the step's memory traffic
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
FLOPS_COUNTED_BY = ("torch.utils.flop_counter.FlopCounterMode: matmul, "
                    "convolution and attention FLOPs only")
TOP_OPS = 12


def _tensors(tree) -> list:
    """The tensors of ``tree``; a ``DTensor`` stands for this rank's local
    shard, the storage it holds."""
    return [getattr(t, "_local_tensor", t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


class TraceCost(TorchDispatchMode):
    """Bytes accessed, live storage bytes and an op histogram of the ops
    dispatched while the mode is active.  Backward ops may run on the
    autograd engine's thread while the caller waits, and storages die in
    weakref callbacks on either thread, so the live-byte books take a
    lock."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.ops: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, tuple] = {}
        self._lock = threading.RLock()

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages as live (the step's arguments);
        returns the bytes they add."""
        before = self.live_bytes
        for t in tensors:
            self._track(t)
        return self.live_bytes - before

    def storage_bytes(self, tensors, exclude=()) -> int:
        """The bytes of ``tensors``' distinct storages, less those of
        ``exclude``'s."""
        skip = {id(t.untyped_storage()) for t in exclude}
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in skip:
                seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                               n)
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        with self._lock:
            _, n = self._live.pop(key)
            self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":
            return out
        outs = _tensors(out)
        if not func.is_view and func.namespace not in COLLECTIVE_NAMESPACES:
            self.ops[str(func.overloadpacket)] += 1
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def aten_ops(self, top: int = TOP_OPS) -> dict[str, int]:
        return dict(self.ops.most_common(top))


@dataclasses.dataclass
class StepCost:
    flops: int
    bytes_accessed: int
    argument_bytes: int
    output_bytes: int
    peak_live_bytes: int
    aten_ops: dict

    @property
    def temp_bytes(self) -> int:
        return self.peak_live_bytes - self.argument_bytes


def step_cost(fn, *args):
    """``fn(*args)`` once under both counters; returns ``(out, StepCost)``.
    The caller activates ``FakeTensorMode`` around this call to trace on
    fake tensors."""
    arg_tensors = _tensors(args)
    cost = TraceCost()
    argument_bytes = cost.hold(arg_tensors)
    flops = FlopCounterMode(display=False)
    with flops, cost:
        out = fn(*args)
    outs = _tensors(out)
    return out, StepCost(
        flops=int(flops.get_total_flops()),
        bytes_accessed=int(cost.bytes_accessed),
        argument_bytes=int(argument_bytes),
        output_bytes=int(cost.storage_bytes(outs, exclude=arg_tensors)),
        peak_live_bytes=int(cost.peak_live_bytes),
        aten_ops=cost.aten_ops())
