"""``ScaleEngine`` — the stacked round engine (reference
``repro.scale.engine``).

A ``RoundEngine`` subclass whose round — gossip mix, local SGD phase, mask
evolution — runs on client-stacked state: one vmapped call per local step
and one stacked call per phase, where the loop engine walks the clients in
Python.

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
``mesh`` (sharding the client dim over a ``DeviceMesh``) is not ported:
the port runs on one card.

Constraints, checked at construction: homogeneous client densities, one
effective batch size for all clients (ragged step counts are padded), and a
strategy with a stacked adapter (``dispfl``, ``dispfl_anneal``, ``dpsgd``).
"""
from __future__ import annotations

import time
from typing import Any, Sequence

import torch

from repro_torch.fl.base import (
    Task,
    evaluate_clients_stacked,
    stack_eval_arrays,
)
from repro_torch.fl.engine import Callback, RoundCtx, RoundEngine, StrategyBase
from repro_torch.obs import CounterSet, SeriesSet, install_torch_hooks, span
from repro_torch.optim.sgd import SGDConfig
from repro_torch.scale.stacked import (
    pack_stacked,
    split_stacked,
    stacked_grads,
    stacked_local_phase,
)
from repro_torch.scale.strategy import make_stacked
from repro_torch.utils.graph import graphed

PyTree = Any


class ScaleEngine(RoundEngine):
    """Runs a strategy as one stacked round on ``task.device``::

        engine = ScaleEngine(make_strategy("dispfl"), task, clients, cfg,
                             reduction="ordered")
        result = engine.run()

    ``reduction`` picks the gossip fold: ``"einsum"`` (matmul, default) or
    ``"ordered"`` (the loop's accumulation order, through the gossip
    kernel).  ``phase_s`` holds each round's seconds per phase (inputs,
    mix, local, evolve, eval on the CPU; inputs, step, eval on the card),
    each ended by a device synchronise.
    """

    def __init__(self, strategy: StrategyBase, task: Task, clients, cfg,
                 callbacks: Sequence[Callback] = (), mesh=None,
                 reduction: str = "einsum"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharding the client dim over a DeviceMesh) is not "
                "ported: the port's ScaleEngine runs on one H100, where a "
                "multi-card mesh cannot be verified (mesh=None)")
        super().__init__(strategy, task, clients, cfg, callbacks=callbacks,
                         local_exec="loop")
        self.adapter = make_stacked(strategy, reduction=reduction)
        self.adapter.validate(cfg)
        self._validate_clients()
        self.state = self.adapter.stack_state(self.state)
        self._opt = SGDConfig(momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
        self._round_step = None
        self._phase_fns: tuple = ()
        self._count_paths: tuple[str, ...] = ()
        self._eval_arrays = None
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
    # the compiled round step
    # ------------------------------------------------------------------
    def _build_round_step(self):
        """The round's phases, each a function of the stacked state and
        the round's device inputs, and ``round_step``, which runs them in
        order, compiled (the reference's ``_build_round_step``)."""
        adapter = self.adapter
        apply_fn = self.task.apply_fn
        opt = self._opt
        paths = self._count_paths

        def mix(state, inp):
            return adapter.stacked_mix(state, inp["mix"])

        def local(state, inp):
            params = stacked_local_phase(
                apply_fn, opt, state["params"], adapter.stacked_masks(state),
                inp["bx"], inp["by"], inp["live"], inp["lr"])
            return {**state, "params": params}

        def evolve(state, inp):
            if not adapter.evolves:
                return state
            grads = stacked_grads(apply_fn, state["params"], inp["ev_x"],
                                  inp["ev_y"])
            counts = inp["counts"]
            return adapter.stacked_evolve(
                state, grads,
                {p: (counts[i, 0], counts[i, 1]) for i, p in enumerate(paths)})

        phases = (("mix", mix), ("local", local), ("evolve", evolve))

        def round_step(state, inp):
            for _, phase in phases:
                state = phase(state, inp)
            return state

        return phases, graphed(round_step, donate=(0,))

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
    def _evolve_batches(self, ctx: RoundCtx):
        """The mask-search batches, drawn from each client's stream right
        after its local-phase orders — the loop's ``evolve`` draw order."""
        bs = self.cfg.batch_size
        xs, ys = zip(*(c.sample_batch(ctx.client_rng(k), bs)
                       for k, c in enumerate(self.clients)))
        return torch.stack(xs), torch.stack(ys)

    def _round_inputs(self, ctx: RoundCtx) -> dict:
        """The round's host draws, in the reference's order, as the round
        step's device inputs: batches, evolve batches and counts, the mix
        input and the learning rate."""
        adapter = self.adapter
        dev = self.device
        bx, by, live = self._stacked_batches(
            ctx, range(len(self.clients)), self.cfg.local_epochs)
        ev_x, ev_y = (self._evolve_batches(ctx) if adapter.evolves
                      else (None, None))
        counts = self._count_tensor(adapter.evolve_counts(ctx))
        return {"mix": adapter.mix_input(ctx, dev), "bx": bx, "by": by,
                "live": live, "ev_x": ev_x, "ev_y": ev_y, "counts": counts,
                "lr": torch.tensor(ctx.lr, dtype=torch.float32, device=dev)}

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _round_phases(self, ctx: RoundCtx, phases: dict, tp: float) -> float:
        """The host inputs on the device, then the round step (mix ->
        local phase -> evolve on the stacked state) inside the
        ``scale.step`` span, with the step counters: on the CPU each phase
        eagerly and timed on its own, on the card the compiled step."""
        dev = self.device
        inp = self._round_inputs(ctx)
        if self._round_step is None:
            self._phase_fns, self._round_step = self._build_round_step()
        step = self._round_step
        tp = self._timed(phases, "inputs", tp)
        n_captures = step.captures
        with span("scale.step", track="engine", round=ctx.t) as sp:
            if dev.type == "cpu":
                state = self.state
                for name, phase in self._phase_fns:
                    state = phase(state, inp)
                    tp = self._timed(phases, name, tp)
                self.state = state
            else:
                self.state = step(self.state, inp)
                tp = self._timed(phases, "step", tp)
            delta = step.captures - n_captures
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
        return (self.adapter.round_comm(self.state, ctx),
                self.adapter.round_flops(ctx))

    def _eval_accs(self, ctx: RoundCtx) -> list[float]:
        return self._stacked_eval()

    def _stacked_eval(self) -> list[float]:
        """Personalized eval in one vmapped call over the stacked params
        (equal to the per-client ``evaluate_clients`` loop)."""
        if self._eval_arrays is None:
            self._eval_arrays = stack_eval_arrays(self.clients, self.device)
        return evaluate_clients_stacked(
            self.task, self.adapter.stacked_eval_params(self.state),
            self.clients, arrays=self._eval_arrays)

    # ------------------------------------------------------------------
    # results / messages / checkpoints
    # ------------------------------------------------------------------
    def _final_accs(self) -> list[float]:
        return self._stacked_eval()

    def snapshot_messages(self) -> list[dict]:
        """Per-client packed payloads of the current stacked state — what
        each client would put on the wire now — via the stacked packer."""
        masks = self.adapter.stacked_masks(self.state)
        stacked = pack_stacked(self.state["params"], masks)
        return [{"packed": p} for p in split_stacked(stacked)]

    def _checkpoint_payload(self) -> dict:
        # the per-client list layout, so ScaleEngine and RoundEngine
        # archives (of either package) are interchangeable
        stacked = self.state
        self.state = self.adapter.unstack_state(stacked)
        try:
            return super()._checkpoint_payload()
        finally:
            self.state = stacked

    def _restore_payload(self, payload: dict) -> None:
        super()._restore_payload(payload)
        self.state = self.adapter.stack_state(self.state)
