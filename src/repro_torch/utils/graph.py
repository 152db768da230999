"""Compiled steps: a step function captured once as a CUDA graph and
replayed, the port's counterpart of ``jax.jit`` (``donate_argnums``
included), with ``disabled()`` for ``jax.disable_jit``.

    step = graphed(train_step, donate=(0,))
    params, losses = step(params, masks, batch, adjacency, lr_tensor)

A graph replays the kernels it recorded, so a replay gives the bits the
same step gives eagerly on the card.  On CPU tensors ``graphed`` calls the
step as it is.  On CUDA tensors, the first call for each input signature
(tree structure, shapes, dtypes, devices) runs the step once eagerly on a
side stream (kernel builds and ctypes loads happen there, never inside a
capture), then captures it into a ``torch.cuda.CUDAGraph`` over static
input buffers; every call copies its inputs into those buffers and
replays.  Arguments are tensors only: a Python number would be baked into
the capture, so it is refused, and per-call scalars (learning rate, prune
rate, counts) travel as device tensors.  Static configuration goes
through the step's closure.  A capture that fails raises; nothing falls
back to eager.

Donation: a donated argument's tensors are the capture's own input
buffers, and the step writes its matching output back into them (the
output, or an element of a tuple output, with the argument's tree
structure, shapes and dtypes), so the caller's state is updated in place
and held once, as XLA reuses a donated buffer.  A donated argument with no
matching output is read in place, never copied (read-only state: the
masks of a train step, the params of a decode, a serving pool): a
capture is keyed by those tensors (their ``data_ptr`` and strides) beside
the signature, so a call that passes them replays it.  Other tensors are
never copied in, which would overwrite tensors their owner still reads:
inside ``new_pools()`` (a serving engine's ``warmup()``) they take a
capture of their own (captured and replayed, with no eager warm-up: the
signature's first capture ran it), so one model serves any number of
stores, and anywhere else they raise ``ValueError``.  The first call of a
signature always captures.  A donated argument with a matching
output costs no copy when it is passed the same tensors again; other
tensors are copied into those buffers.  Other outputs are returned as
fresh tensors, so a later replay never overwrites a result the caller
holds.  A capture keeps its donated tensors alive until ``release()``;
the captures of one ``Graphed`` share one graph memory pool, which is safe
because each replay's outputs are cloned (or written back into donated
tensors) before another replay runs, and ``pool_bytes()`` gives the device
memory each capture added to it.

The kernel wrappers count a launch in Python where they call their C
entry, which a capture runs once and a replay not at all.  So ``graphed``
takes the counts a capture added (``kernels.build.launch_counts``: every
wrapper module that joined its registry) back out and adds them on every
replay: each wrapper's counts stay the launches the card ran.  A capture
that launched a C entry no registered wrapper counted raises.

A step may hold a collective (``graphed(fn, collectives=True)``, a
client-sharded round's gather).  NCCL's can be captured once the
communicator has run one collective eagerly, which the signature's eager
warm-up does before its capture; the capture then records in
``thread_local`` error mode, so another thread's CUDA calls (the process
group's watchdog) do not invalidate it.  Gloo's run on the host and cannot
be captured: a step that holds one is built as graphed segments around the
eager collective.  ``collective_capture(backend)`` says which, from the
backend alone; nothing tries a capture and falls back.

``check_capturable()`` is the CPU check that a step can be captured: a
dispatch mode that refuses host reads, data-dependent shapes and tensors
built from host data inside the step.  It cannot see a Python number that
the step bakes in; that shows only as a replay that differs on the card.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels import build

_STATE = threading.local()

#: process-group backends whose collectives a CUDA graph records
CAPTURABLE_BACKENDS = ("nccl",)


def collective_capture(backend: str) -> str:
    """How a step holding a collective of ``backend`` is compiled on the
    card: ``"whole"``, one graph with the collective inside (NCCL), or
    ``"segments"``, graphs around an eager collective (gloo)."""
    return "whole" if backend in CAPTURABLE_BACKENDS else "segments"


@contextlib.contextmanager
def disabled():
    """Within it, every ``graphed`` step of this thread runs eagerly, on
    whatever device its tensors are (``jax.disable_jit``)."""
    before = getattr(_STATE, "disabled", False)
    _STATE.disabled = True
    try:
        yield
    finally:
        _STATE.disabled = before


def is_disabled() -> bool:
    return getattr(_STATE, "disabled", False)


@contextlib.contextmanager
def new_pools():
    """Within it, a graphed step of this thread whose read-in-place
    arguments are given tensors that no capture of its signature holds
    takes a capture for them (a serving model's second store), where
    outside it they raise ``ValueError``."""
    before = getattr(_STATE, "new_pools", False)
    _STATE.new_pools = True
    try:
        yield
    finally:
        _STATE.new_pools = before


# ---------------------------------------------------------------------------
# graphed
# ---------------------------------------------------------------------------


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order, as ``jax.tree_util``
    orders them: a state whose dicts were rebuilt in another key order is
    the same input."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(x) for x in tree)
    return tree


def _leaves(args) -> tuple[list, Any]:
    """The tensor leaves and the structure of ``args``; ``None`` is
    structure (an absent input), any other non-tensor is refused."""
    leaves, spec = tree_flatten(_sorted(args))
    for i, x in enumerate(leaves):
        if x is not None and not isinstance(x, torch.Tensor):
            raise TypeError(
                f"graphed step argument leaf {i} is a {type(x).__name__}: a "
                "capture would bake it in; pass a (0-d) tensor for a "
                "per-call value and close over static configuration")
    return leaves, spec


def _signature(leaves, spec) -> tuple:
    return (str(spec),) + tuple(None if x is None else
                                (tuple(x.shape), x.dtype, x.device)
                                for x in leaves)


def signature(args) -> tuple:
    """The input signature ``graphed`` keys its captures by: the tree
    structure of ``args`` and each tensor's shape, dtype and device."""
    return _signature(*_leaves(args))


def _same_layout(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x is y is None or (isinstance(x, torch.Tensor)
                           and isinstance(y, torch.Tensor)
                           and x.shape == y.shape and x.dtype == y.dtype)
        for x, y in zip(a, b))


def _place(x: torch.Tensor) -> tuple:
    return x.data_ptr(), x.stride()


class _Capture:
    """One input signature's graph for one set of read-in-place tensors:
    static inputs and which of them are donated with no matching output,
    the outputs it writes, which of them alias a donated argument, its
    counter delta and the bytes its capture added to the graph pool."""

    def __init__(self, graph, inputs, read_only, out_spec, outputs, aliased,
                 delta, pool_bytes):
        self.graph = graph
        self.inputs = inputs
        self.read_only = read_only
        self.out_spec = out_spec
        self.outputs = outputs
        self.aliased = aliased
        self.delta = delta
        self.pool_bytes = pool_bytes

    def reads(self, leaves) -> bool:
        """Whether ``leaves`` pass this capture's own tensors wherever it
        reads an argument in place."""
        return all(_place(x) == _place(leaves[i])
                   for i, (x, ro) in enumerate(zip(self.inputs,
                                                   self.read_only)) if ro)


class Graphed:
    """``fn`` captured per input signature; see the module docstring.
    ``captures`` and ``replays`` count this callable's own, ``capture_s``
    the host seconds its captures took (warm-up run included)."""

    def __init__(self, fn: Callable, donate: Sequence[int] = (),
                 collectives: bool = False):
        self.fn = fn
        self.donate = tuple(donate)
        self.collectives = collectives
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._graphs: dict[tuple, list[_Capture]] = {}
        self._mempool = None

    def captured(self) -> list[_Capture]:
        """Every capture, in the order they were taken."""
        return [c for caps in self._graphs.values() for c in caps]

    def pool_bytes(self) -> list[int]:
        """Per capture, the device bytes its capture reserved in the graph
        memory pool the captures share (what it holds until
        ``release()``)."""
        return [c.pool_bytes for c in self.captured()]

    def release(self) -> None:
        """Drop every captured graph and their memory pool."""
        self._graphs.clear()
        self._mempool = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def __call__(self, *args):
        leaves, spec = _leaves(args)
        if is_disabled() or not any(x is not None and x.is_cuda
                                    for x in leaves):
            return self.fn(*args)
        devices = {x.device for x in leaves if x is not None}
        if len(devices) != 1:
            raise ValueError(f"a graphed step's tensors must share one "
                             f"device, got {sorted(map(str, devices))}")
        caps = self._graphs.setdefault(_signature(leaves, spec), [])
        cap = next((c for c in caps if c.reads(leaves)), None)
        if cap is None:
            if caps and not getattr(_STATE, "new_pools", False):
                raise ValueError(
                    "a donated argument with no matching output is read in "
                    "place: pass its capture's own tensors (copying others "
                    "in would overwrite them)")
            cap = self._capture(args, leaves, spec, warm_up=not caps)
            caps.append(cap)
        else:
            for i, (static, x) in enumerate(zip(cap.inputs, leaves)):
                if x is not static and not cap.read_only[i]:
                    cap.inputs[i].copy_(x)       # None is static
        cap.graph.replay()
        self.replays += 1
        build.add_launch_counts(cap.delta)
        outs = [o if a or o is None else o.clone()
                for o, a in zip(cap.outputs, cap.aliased)]
        return tree_unflatten(outs, cap.out_spec)

    def _static_inputs(self, args, leaves) -> list:
        """The donated arguments' own tensors, clones of the others."""
        donated = set()
        for i in self.donate:
            donated.update(id(x) for x in tree_flatten(args[i])[0]
                           if x is not None)
        return [x if x is None or id(x) in donated else x.clone()
                for x in leaves]

    def _donated_targets(self, static_args, out):
        """Per output leaf, the donated input tensor it is written back
        into (or None): each donated argument takes the whole output, or
        the first element of a tuple output, with its structure, shapes
        and dtypes that no other donated argument took."""
        out_leaves, _ = tree_flatten(out)
        targets = [None] * len(out_leaves)
        candidates = [(out, 0)]
        if isinstance(out, (tuple, list)):
            start = 0
            for o in out:
                candidates.append((o, start))
                start += len(tree_flatten(o)[0])
        taken = set()
        for i in self.donate:
            arg_leaves, arg_spec = tree_flatten(static_args[i])
            for j, (cand, start) in enumerate(candidates):
                c_leaves, c_spec = tree_flatten(cand)
                if (j not in taken and c_spec == arg_spec
                        and _same_layout(c_leaves, arg_leaves)):
                    taken.add(j)
                    for n, d in enumerate(arg_leaves):
                        targets[start + n] = d
                    break
        return targets

    def _capture(self, args, leaves, spec, warm_up: bool) -> _Capture:
        t0 = time.perf_counter()
        device = next(x.device for x in leaves if x is not None)
        static = self._static_inputs(args, leaves)
        static_args = tree_unflatten(static, spec)
        if warm_up:
            # on a side stream: first kernel builds, library handles and
            # cuBLAS workspaces are made outside the capture (a signature's
            # later captures, of other pools, run what its first ran)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                warm = self.fn(*static_args)
            torch.cuda.current_stream(device).wait_stream(side)
            del warm
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: a collected object that
        # holds another graph would destroy it mid-capture, which the
        # runtime refuses, and the capture would be invalidated
        collecting = gc.isenabled()
        gc.disable()
        try:
            mode = "thread_local" if self.collectives else "global"
            with torch.cuda.graph(graph, pool=self._mempool,
                                  capture_error_mode=mode):
                out = _sorted(self.fn(*static_args))
                targets = self._donated_targets(static_args, out)
                out_leaves, out_spec = tree_flatten(out)
                for o, d in zip(out_leaves, targets):
                    if d is not None and o is not d:
                        d.copy_(o)
        finally:
            if collecting:
                gc.enable()
            delta = build.launch_count_delta(before, build.launch_counts())
            build.add_launch_counts(delta, -1)      # recorded, not run
        build.check_counted(delta)
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        outputs = [o if d is None else d for o, d in zip(out_leaves, targets)]
        written = {id(d) for d in targets if d is not None}
        read_only = [x is not None and x is leaf and id(x) not in written
                     for x, leaf in zip(static, leaves)]
        return _Capture(graph, static, read_only, out_spec, outputs,
                        [d is not None for d in targets], delta, pool_bytes)


def graphed(fn: Callable, donate: Sequence[int] = (),
            collectives: bool = False) -> Graphed:
    """``fn`` as a compiled step: eager on CPU tensors, a CUDA graph per
    input signature on the card; ``donate`` lists the argument indices
    whose tensors the step may update in place; ``collectives`` says the
    step holds a collective of a capturable backend (NCCL)."""
    return Graphed(fn, donate, collectives)


# ---------------------------------------------------------------------------
# the CPU check that a step can be captured
# ---------------------------------------------------------------------------


class CaptureError(RuntimeError):
    """An op a CUDA-graph capture refuses, or bakes in, inside a step."""


_HOST_READS = ("aten._local_scalar_dense",)
_DATA_SHAPES = ("aten.nonzero", "aten.masked_select")
_HOST_DATA = ("aten.lift_fresh",)


class _CaptureCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        why = None
        if name in _HOST_READS:
            why = "reads a device value on the host"
        elif name in _DATA_SHAPES:
            why = "has a data-dependent shape"
        elif name == "aten.index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())):
            why = "indexes by a boolean mask (a data-dependent shape)"
        elif name in _HOST_DATA:
            why = "builds a tensor from host data"
        if why is not None:
            raise CaptureError(f"{func} {why}: a CUDA-graph capture "
                               "refuses it or bakes it in")
        return func(*args, **(kwargs or {}))


def _refuse_host_copy(self, *args, **kwargs):
    raise CaptureError("Tensor.tolist/numpy reads device values on the "
                       "host: a CUDA-graph capture refuses it")


@contextlib.contextmanager
def check_capturable():
    """Within it, an op that a capture would refuse or bake in raises
    ``CaptureError``: a host read (``.item()``, ``int(t)``, ``float(t)``,
    ``bool(t)``, ``.tolist()``, ``.numpy()``), a data-dependent shape
    (``nonzero``, ``masked_select``, a boolean index) or a tensor built
    from host data (``torch.tensor``, ``torch.as_tensor`` of a number or
    an array).  ``tolist`` and ``numpy`` dispatch no op, so they are
    patched on ``torch.Tensor`` for the context's span."""
    saved = torch.Tensor.tolist, torch.Tensor.numpy
    torch.Tensor.tolist = torch.Tensor.numpy = _refuse_host_copy
    try:
        with _CaptureCheck():
            yield
    finally:
        torch.Tensor.tolist, torch.Tensor.numpy = saved
