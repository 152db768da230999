"""``ScaleEngine`` — the stacked round engine (reference
``repro.scale.engine``).

A ``RoundEngine`` subclass whose round — gossip mix, local SGD phase, mask
evolution — runs on client-stacked state: vmapped calls per local step
(``CLIENTS_PER_CALL`` clients each) and one stacked call per phase, where
the loop engine walks the clients in Python.

Semantics contract (``tests/test_torch_scale.py``):

* round-0 state is the loop engine's (the adapter stacks the base
  strategy's own ``init_state``);
* all randomness (batch orders, evolve batches, topology) comes from the
  same ``(seed, round, client)`` streams in the same draw order, so a
  checkpoint resumes identically — and interchangeably with
  ``RoundEngine``, in either package: archives are written in the
  per-client list layout;
* ``reduction="ordered"`` mixes in the loop's order with the gossip kernel,
  so its masks equal the loop engine's; parameters differ from it only by
  the fp32 rounding of the vmapped (grouped) convolutions;
* ``reduction="einsum"`` mixes by matmul: values agree within fp32
  rounding, masks as long as no drift crosses a top-k tie.

The round's mix, local phase and evolve are one ``round_step``, built
once (``_build_round_step``, as the reference's) and compiled with
``utils.graph.graphed``, the reference's ``jax.jit``: on the card the
first round captures it as a CUDA graph and every later round replays it,
with the round's learning rate, topology and evolve counts as device
tensors, so ``step_compiles`` (rounds whose step captured) reads 1 over a
run, the reference's invariant.  The ``ordered`` mix takes a (K, J)
in-neighbour index whose width is the topology's in-degree bound, so
neither a new topology nor a drop changes the step's input shapes.  On
the CPU the same phases run eagerly, each timed on its own (``mix``,
``local``, ``evolve`` in ``phase_s``), and ``step_compiles`` reads 0; one
graph has no boundaries inside it, so the card times the ``step`` whole.

``mesh`` (a ``torch.distributed`` ``DeviceMesh``, one process per
position, the reference's ``mesh=``) shards the stacked client dim over
the client axes (``sharding.rules.stacked_spec``: ('pod','data') or
('data',), trimmed until they divide K; trimmed to nothing, every rank
holds all K).  A rank holds its clients ``k0:k1``, pod-major, as DTensor
lays out ``Shard(0)`` over those axes; the 'model' axis holds replicas.
Every rank makes every host draw (topology, batch orders, evolve batches,
counts, lr) in the reference's order and takes only its own clients'
batches to the device.  The round's one collective is the mix's gather:
each rank's masked params and masks, flattened into one (K_local, N)
buffer per dtype, all-gathered over the client axes into (K, N) in client
order; each rank then mixes its own receivers (``masked_gossip_stacked``'s
``receivers``: the ``ordered`` mix launches each receiver's kernel as the
unsharded round does, so its bits are that round's).  The local phase and
the evolve are local.  With NCCL the round is one graph, the gather
inside; with gloo it is two graphed segments (pack, then mix + local +
evolve) around the eager gather (``utils.graph.collective_capture``;
``capture`` names the form).  The eval gathers the per-client accuracies
in client order; ``save`` gathers the whole stacked state and rank 0
writes the archive the unsharded engine writes; ``restore`` keeps each
rank's slice, so archives cross between meshed, unsharded and reference
engines.

Constraints, checked at construction: homogeneous client densities, one
effective batch size for all clients (ragged step counts are padded), and a
strategy with a stacked adapter (``dispfl``, ``dispfl_anneal``, ``dpsgd``).
"""
from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.npz import save_pytree
from repro_torch.fl.base import Task, stack_eval_arrays
from repro_torch.fl.engine import Callback, RoundCtx, RoundEngine, StrategyBase
from repro_torch.obs import CounterSet, SeriesSet, install_torch_hooks, span
from repro_torch.optim.sgd import SGDConfig
from repro_torch.scale.stacked import (
    pack_stacked,
    split_stacked,
    stacked_grads,
    stacked_local_phase,
    stacked_nnz_per_client,
)
from repro_torch.scale.strategy import make_stacked
from repro_torch.sharding.rules import axis_names, axis_sizes, stacked_spec
from repro_torch.utils.graph import collective_capture, graphed
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

PyTree = Any

#: clients a vmapped call of the local phase, the evolve gradients and eval:
#: one, so no mesh splits a call and a client's bits do not depend on it
CLIENTS_PER_CALL = 1
#: the state key the mesh's gather phase hands the mix its (K, N) buffers in
_GATHERED = "_gathered"
# torch 2.13 renames all_gather_into_tensor (same arguments); older has one
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


class ClientShard:
    """The clients one rank of ``mesh`` holds, of K stacked ones, and the
    client axes' process group.

    ``axes`` are the client axes of ``stacked_spec((k,), mesh)`` (None: not
    sharded, every rank holds all K); ``index`` is this rank's position
    along them, pod-major, so it holds clients ``k0:k1``, ``k_local`` of
    them.  The ranks that share every other mesh coordinate gather
    together: one axis is the mesh's own group of that dim; two are
    enumerated over ``mesh.mesh`` (every rank builds every such group, in
    one order).  ``backend`` is that group's."""

    def __init__(self, mesh: DeviceMesh, k: int):
        self.mesh = mesh
        self.k = k
        entry = stacked_spec((k,), mesh)[0]
        self.axes = (() if entry is None else
                     (entry,) if isinstance(entry, str) else tuple(entry))
        names, sizes = axis_names(mesh), axis_sizes(mesh)
        self.group = None
        self.index, self.size = 0, 1
        if len(self.axes) == 1:
            self.group = mesh.get_group(self.axes[0])
        elif self.axes:
            dims = [names.index(a) for a in self.axes]
            rest = [d for d in range(len(names)) if d not in dims]
            size = 1
            for a in self.axes:
                size *= sizes[a]
            columns = mesh.mesh.permute(dims + rest).reshape(size, -1).T
            self.group, _ = dist.new_subgroups_by_enumeration(
                [c.tolist() for c in columns])
        if self.group is not None:
            self.size = dist.get_world_size(self.group)
            self.index = dist.get_rank(self.group)
            coord = mesh.get_coordinate()
            want = 0
            for a in self.axes:
                want = want * sizes[a] + coord[names.index(a)]
            if want != self.index:
                raise RuntimeError(f"client group rank {self.index} is not "
                                   f"the pod-major position {want}")
        self.backend = dist.get_backend(self.group)
        self.k_local = k // self.size
        self.k0 = self.index * self.k_local
        self.k1 = self.k0 + self.k_local

    @property
    def own(self) -> range:
        return range(self.k0, self.k1)

    def slice(self, tree: PyTree) -> PyTree:
        """This rank's rows ``k0:k1`` of a stacked (K, ...) tree, as
        tensors of their own."""
        return tree_map(lambda x: x[self.k0:self.k1].clone(), tree)

    def pack(self, tree: PyTree) -> dict:
        """A stacked (K_local, ...) tree as one (K_local, N) buffer per
        dtype, its leaves in ``tree_leaves`` order."""
        groups: dict = {}
        for x in tree_leaves(tree):
            groups.setdefault(x.dtype, []).append(x.reshape(x.shape[0], -1))
        return {str(d): torch.cat(xs, dim=1) for d, xs in groups.items()}

    def unpack(self, bufs: dict, like: PyTree) -> PyTree:
        """(K, N) buffers back into a (K, ...) tree shaped as ``like``
        (views into the buffers)."""
        offsets = dict.fromkeys(bufs, 0)
        leaves = []
        for x in tree_leaves(like):
            d, n = str(x.dtype), x[0].numel()
            buf = bufs[d]
            leaves.append(buf[:, offsets[d]:offsets[d] + n].reshape(
                buf.shape[0], *x.shape[1:]))
            offsets[d] += n
        return tree_unflatten_like(like, leaves)

    def gather(self, bufs: dict) -> dict:
        """Each (K_local, N) buffer all-gathered over the client axes into
        (K, N), rows in client order."""
        out = {}
        for d, x in bufs.items():
            full = x.new_empty((self.k, *x.shape[1:]))
            _all_gather(full, x, group=self.group)
            out[d] = full
        return out

    def gather_tree(self, tree: PyTree) -> PyTree:
        """This rank's (K_local, ...) tree as the whole (K, ...) tree."""
        return self.unpack(self.gather(self.pack(tree)), tree)

    def gather_values(self, values: Sequence, dtype=torch.float64) -> list:
        """Per-client host numbers of this rank's clients as the list of
        all K, in client order."""
        dev = ("cpu" if self.backend == "gloo" else
               torch.device("cuda", torch.cuda.current_device()))
        x = torch.tensor(list(values), dtype=dtype, device=dev)
        full = x.new_empty(self.k)
        _all_gather(full, x, group=self.group)
        return full.tolist()

    def received_bytes(self, tree: PyTree) -> int:
        """Bytes one gather of ``tree`` brings this rank from the others."""
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(tree)) // self.k_local * (
                       self.k - self.k_local)


class ScaleEngine(RoundEngine):
    """Runs a strategy as one stacked round on ``task.device``::

        engine = ScaleEngine(make_strategy("dispfl"), task, clients, cfg,
                             reduction="ordered")
        result = engine.run()

    ``reduction`` picks the gossip fold: ``"einsum"`` (matmul, default) or
    ``"ordered"`` (the loop's accumulation order, through the gossip
    kernel).  ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_test_mesh``)
    to shard the clients over, or None.  ``phase_s`` holds each round's
    seconds per phase (inputs, mix, local, evolve, eval on the CPU, a
    meshed round's gather before its mix; inputs, step, eval on the card,
    with gloo inputs, gather, step, eval), each ended by a device
    synchronise.  ``capture`` says how the round is compiled: ``"eager"``
    (the CPU), ``"whole"`` (one graph) or ``"segments"`` (gloo: graphs
    around the eager gather).

    The local phase, the evolve gradients and eval take
    ``CLIENTS_PER_CALL`` clients a vmapped call, whatever the mesh: a
    convolution vmapped over n clients is one grouped convolution of n
    groups, and cuDNN chooses its algorithm by the group count, so a
    call's width that followed the rank's client count would make a
    client's bits on the card depend on the mesh.  Every call stays inside
    the one compiled round, so the calls add launches and no host time.
    """

    def __init__(self, strategy: StrategyBase, task: Task, clients, cfg,
                 callbacks: Sequence[Callback] = (), mesh=None,
                 reduction: str = "einsum"):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(launch.mesh.make_test_mesh) or None, got "
                            f"{type(mesh).__name__}")
        super().__init__(strategy, task, clients, cfg, callbacks=callbacks,
                         local_exec="loop")
        self.adapter = make_stacked(strategy, reduction=reduction)
        self.adapter.validate(cfg)
        self._validate_clients()
        self.mesh = mesh
        self.shard = (None if mesh is None else
                      ClientShard(mesh, len(self.clients)))
        self.state = self._mine(self.adapter.stack_state(self.state))
        self.capture = ("eager" if self.device.type == "cpu" else
                        "whole" if self.shard is None or not self.shard.axes
                        else collective_capture(self.shard.backend))
        self._opt = SGDConfig(momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
        self._round_step = None
        self._phase_fns: tuple = ()
        self._count_paths: tuple[str, ...] = ()
        self._eval_arrays = None
        #: per round: the bytes the mix's gather brought this rank
        self.gather_bytes: list[int] = []
        install_torch_hooks()
        self.scale_obs = CounterSet("scale.engine")
        self._c_step_calls = self.scale_obs.counter("step_calls")
        self._c_step_compiles = self.scale_obs.counter("step_compiles")
        # cumulative step/compile series on the wall clock (counter-kind);
        # not checkpointed — a resumed run restarts its series
        self.scale_series = SeriesSet("scale.engine")
        self._series_epoch = time.perf_counter()

    def _validate_clients(self) -> None:
        cfg = self.cfg
        bss = {min(cfg.batch_size, c.n_train) for c in self.clients}
        if len(bss) != 1:
            raise ValueError(
                "ScaleEngine requires all clients to share one effective "
                f"batch size (min(batch_size, n_train)); got {sorted(bss)} "
                "— ragged *step counts* are fine (padded + masked), ragged "
                "batch shapes are not; use RoundEngine")

    @property
    def step_compiles(self) -> int:
        """Rounds whose step dispatch captured a CUDA graph: 1 over a run
        on the card (the reference's "traced scalars never recompile"),
        0 on the CPU, where the step runs eagerly."""
        return int(self._c_step_compiles.value)

    # ------------------------------------------------------------------
    # the client shard
    # ------------------------------------------------------------------
    @property
    def _gathers(self) -> bool:
        return self.shard is not None and bool(self.shard.axes)

    def _mine(self, state: dict) -> dict:
        """This rank's clients of a stacked (K) state."""
        if not self._gathers:
            return state
        return {k: self.shard.slice(v) if k in self.adapter.state_keys
                else v for k, v in state.items()}

    def _full_state(self) -> dict:
        """The whole stacked (K) state, gathered (a collective: every rank
        of the mesh calls it)."""
        if not self._gathers:
            return self.state
        return {k: self.shard.gather_tree(v) if k in self.adapter.state_keys
                else v for k, v in self.state.items()}

    def _stacked_part(self, state: dict) -> dict:
        return {k: state[k] for k in self.adapter.state_keys}

    # ------------------------------------------------------------------
    # the compiled round step
    # ------------------------------------------------------------------
    def _build_round_step(self):
        """The round's phases, each a function of the stacked state and
        the round's device inputs, and the compiled round (the reference's
        ``_build_round_step``): ``round_step`` runs the phases in order.
        A meshed round's first phase, ``gather``, hands the mix the K
        senders' (K, N) buffers; under gloo on the card the compiled round
        is ``(pack, rest)``, graphed around the eager gather."""
        adapter = self.adapter
        apply_fn = self.task.apply_fn
        opt = self._opt
        paths = self._count_paths
        shard = self.shard if self._gathers else None
        stacked = self._stacked_part
        by_blocks = self._by_blocks

        def gather(state, inp):
            return {**state, _GATHERED: shard.gather(shard.pack(
                stacked(state)))}

        def mix(state, inp):
            if shard is None:
                return adapter.stacked_mix(state, inp["mix"])
            state = dict(state)
            full = shard.unpack(state.pop(_GATHERED), stacked(state))
            return adapter.stacked_mix(state, inp["mix"], full=full,
                                       receivers=(shard.k0, shard.k1))

        def local(state, inp):
            params = by_blocks(
                lambda p, m, x, y, live: stacked_local_phase(
                    apply_fn, opt, p, m, x, y, live, inp["lr"]),
                state["params"], adapter.stacked_masks(state), inp["bx"],
                inp["by"], inp["live"])
            return {**state, "params": params}

        def evolve(state, inp):
            if not adapter.evolves:
                return state
            grads = by_blocks(lambda p, x, y: stacked_grads(apply_fn, p, x, y),
                              state["params"], inp["ev_x"], inp["ev_y"])
            counts = inp["counts"]
            return adapter.stacked_evolve(
                state, grads,
                {p: (counts[i, 0], counts[i, 1]) for i, p in enumerate(paths)})

        phases = (("mix", mix), ("local", local), ("evolve", evolve))
        if shard is not None:
            phases = (("gather", gather),) + phases

        def run(state, inp, todo):
            for _, phase in todo:
                state = phase(state, inp)
            return state

        if self.capture == "segments":
            def rest(state, full, inp):
                return run({**state, _GATHERED: full}, inp, phases[1:])

            pack = graphed(lambda state: shard.pack(stacked(state)),
                           donate=(0,))
            return phases, (pack, graphed(rest, donate=(0,)))
        return phases, graphed(lambda state, inp: run(state, inp, phases),
                               donate=(0,), collectives=shard is not None)

    @staticmethod
    def _by_blocks(fn, *trees):
        """``fn`` over the stacked trees' clients, ``CLIENTS_PER_CALL`` at
        a time, the results concatenated: every call is the same call on an
        unsharded engine and on every mesh."""
        k = tree_leaves(trees[0])[0].shape[0]
        outs = [fn(*(tree_map(lambda t: t[a:a + CLIENTS_PER_CALL], x)
                     for x in trees))
                for a in range(0, k, CLIENTS_PER_CALL)]
        return tree_map(lambda *ys: torch.cat(ys), *outs)

    def _count_tensor(self, counts: dict):
        """The round's ``(n_keep, n_prune)`` per leaf as one (L, 2) int64
        tensor on the device, in the order the step was built with."""
        if not counts:
            return None
        if not self._count_paths:
            self._count_paths = tuple(counts)
        if tuple(counts) != self._count_paths:
            raise ValueError("the evolve counts changed leaves between "
                             "rounds: the round step is built for "
                             f"{self._count_paths}")
        return torch.tensor([counts[p] for p in self._count_paths],
                            dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------
    # host-side per-round inputs (the reference's draws, in its order)
    # ------------------------------------------------------------------
    def _evolve_batches(self, ctx: RoundCtx, own: Optional[range] = None):
        """The mask-search batches, drawn from each client's stream right
        after its local-phase orders — the loop's ``evolve`` draw order —
        for every client; those of ``own`` (default: all) are stacked."""
        bs = self.cfg.batch_size
        drawn = [c.sample_batch(ctx.client_rng(k), bs)
                 for k, c in enumerate(self.clients)]
        xs, ys = zip(*(drawn[k] for k in own or range(len(drawn))))
        return torch.stack(xs), torch.stack(ys)

    def _round_inputs(self, ctx: RoundCtx) -> dict:
        """The round's host draws, in the reference's order, as the round
        step's device inputs: batches, evolve batches and counts, the mix
        input and the learning rate.  A meshed rank draws for every
        client and stacks its own clients' batches."""
        adapter = self.adapter
        dev = self.device
        k = len(self.clients)
        own = self.shard.own if self._gathers else range(k)
        bx, by, live = self._stacked_batches(
            ctx, range(k), self.cfg.local_epochs, keep=own)
        ev_x, ev_y = (self._evolve_batches(ctx, own) if adapter.evolves
                      else (None, None))
        counts = self._count_tensor(adapter.evolve_counts(ctx))
        return {"mix": adapter.mix_input(ctx, dev), "bx": bx, "by": by,
                "live": live, "ev_x": ev_x, "ev_y": ev_y, "counts": counts,
                "lr": torch.tensor(ctx.lr, dtype=torch.float32, device=dev)}

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _captures(self) -> int:
        step = self._round_step
        return sum(s.captures for s in (step if isinstance(step, tuple)
                                        else (step,)))

    def _round_phases(self, ctx: RoundCtx, phases: dict, tp: float) -> float:
        """The host inputs on the device, then the round step (gather ->
        mix -> local phase -> evolve on the stacked state) inside the
        ``scale.step`` span, with the step counters: on the CPU each phase
        eagerly and timed on its own, on the card the compiled step (under
        gloo its two segments around the eager gather, timed apart)."""
        dev = self.device
        inp = self._round_inputs(ctx)
        if self._round_step is None:
            self._phase_fns, self._round_step = self._build_round_step()
        step = self._round_step
        tp = self._timed(phases, "inputs", tp)
        n_captures = self._captures()
        if self._gathers:
            self.gather_bytes.append(
                self.shard.received_bytes(self._stacked_part(self.state)))
        with span("scale.step", track="engine", round=ctx.t) as sp:
            if self.capture == "eager":
                state = self.state
                for name, phase in self._phase_fns:
                    state = phase(state, inp)
                    tp = self._timed(phases, name, tp)
                self.state = state
            elif self.capture == "segments":
                pack, rest = step
                full = self.shard.gather(pack(self.state))
                tp = self._timed(phases, "gather", tp)
                self.state = rest(self.state, full, inp)
                tp = self._timed(phases, "step", tp)
            else:
                self.state = step(self.state, inp)
                tp = self._timed(phases, "step", tp)
            delta = self._captures() - n_captures
            sp.attrs["compiles"] = delta
        self._c_step_calls.inc()
        if delta > 0:
            self._c_step_compiles.inc()
        tw = time.perf_counter() - self._series_epoch
        self.scale_series.series("step_calls", kind="counter").observe(
            tw, float(self._c_step_calls.value))
        self.scale_series.series("step_compiles", kind="counter").observe(
            tw, float(self._c_step_compiles.value))
        return tp

    def _round_accounting(self, ctx: RoundCtx):
        nnz = None
        if self._gathers and "masks" in self.adapter.state_keys:
            nnz = [int(n) for n in self.shard.gather_values(
                stacked_nnz_per_client(self.state["masks"]), torch.int64)]
        return (self.adapter.round_comm(self.state, ctx, nnz=nnz),
                self.adapter.round_flops(ctx))

    def _eval_accs(self, ctx: RoundCtx) -> list[float]:
        return self._stacked_eval()

    def _stacked_eval(self) -> list[float]:
        """Personalized eval, vmapped over the stacked params
        ``CLIENTS_PER_CALL`` clients a call (equal to the per-client
        ``evaluate_clients`` loop).  A meshed rank
        evaluates its own clients on their rows of the K clients' padded
        test arrays and gathers all K accuracies."""
        if self._eval_arrays is None:
            arrays = stack_eval_arrays(self.clients, self.device)
            if self._gathers:
                arrays = tuple(a[self.shard.k0:self.shard.k1].clone()
                               for a in arrays)
            self._eval_arrays = arrays
        accs = self._by_blocks(
            self.task.accuracy_stacked,
            self.adapter.stacked_eval_params(self.state),
            *self._eval_arrays).tolist()
        return self.shard.gather_values(accs) if self._gathers else accs

    # ------------------------------------------------------------------
    # results / messages / checkpoints
    # ------------------------------------------------------------------
    def _final_accs(self) -> list[float]:
        return self._stacked_eval()

    def snapshot_messages(self) -> list[dict]:
        """Per-client packed payloads of the current stacked state — what
        each client would put on the wire now — via the stacked packer
        (all K; meshed, a collective)."""
        state = self._full_state()
        masks = self.adapter.stacked_masks(state)
        stacked = pack_stacked(state["params"], masks)
        return [{"packed": p} for p in split_stacked(stacked)]

    def _checkpoint_payload(self) -> dict:
        # the per-client list layout, so ScaleEngine and RoundEngine
        # archives (of either package) are interchangeable
        own = self.state
        self.state = self.adapter.unstack_state(self._full_state())
        try:
            return super()._checkpoint_payload()
        finally:
            self.state = own

    def save(self, path: str) -> None:
        """Write the archive; meshed, every rank gathers and global rank 0
        writes, then the world waits for it."""
        payload = self._checkpoint_payload()
        if self.shard is None:
            save_pytree(path, payload)
            return
        if dist.get_rank() == 0:
            save_pytree(path, payload)
        dist.barrier()

    def _restore_payload(self, payload: dict) -> None:
        super()._restore_payload(payload)
        self.state = self._mine(self.adapter.stack_state(self.state))
