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

The round runs eagerly (the kernels launch through ctypes, which does not
trace), so ``step_compiles`` — rounds whose step triggered a
``torch.compile`` — stays 0.  ``mesh`` (sharding the client dim over a
``DeviceMesh``) is not ported: the port runs on one card.

Constraints, checked at construction: homogeneous client densities, one
effective batch size for all clients (ragged step counts are padded), and a
strategy with a stacked adapter (``dispfl``, ``dispfl_anneal``, ``dpsgd``).
"""
from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np

from repro_torch.fl.base import (
    Task,
    evaluate_clients_stacked,
    stack_eval_arrays,
)
from repro_torch.fl.engine import Callback, RoundCtx, RoundEngine, StrategyBase
from repro_torch.obs import (
    CounterSet,
    SeriesSet,
    install_torch_hooks,
    span,
    torch_compile_count,
)
from repro_torch.optim.sgd import SGDConfig
from repro_torch.scale.stacked import (
    pack_stacked,
    split_stacked,
    stacked_grads,
    stacked_local_phase,
)
from repro_torch.scale.strategy import make_stacked

PyTree = Any


class ScaleEngine(RoundEngine):
    """Runs a strategy as one stacked round on ``task.device``::

        engine = ScaleEngine(make_strategy("dispfl"), task, clients, cfg,
                             reduction="ordered")
        result = engine.run()

    ``reduction`` picks the gossip fold: ``"einsum"`` (matmul, default) or
    ``"ordered"`` (the loop's accumulation order, through the gossip
    kernel).  ``phase_s`` holds each round's seconds per phase (inputs,
    mix, local, evolve, eval), each ended by a device synchronise.
    """

    def __init__(self, strategy: StrategyBase, task: Task, clients, cfg,
                 callbacks: Sequence[Callback] = (), mesh=None,
                 reduction: str = "einsum"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharding the client dim over a DeviceMesh) is not "
                "ported yet; the port's ScaleEngine runs on one card "
                "(mesh=None)")
        super().__init__(strategy, task, clients, cfg, callbacks=callbacks,
                         local_exec="loop")
        self.adapter = make_stacked(strategy, reduction=reduction)
        self.adapter.validate(cfg)
        self._validate_clients()
        self.state = self.adapter.stack_state(self.state)
        self._opt = SGDConfig(momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
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
        """Rounds whose step triggered a ``torch.compile``: 0, since the
        round runs eagerly."""
        return int(self._c_step_compiles.value)

    # ------------------------------------------------------------------
    # host-side per-round inputs (the reference's draws, in its order)
    # ------------------------------------------------------------------
    def _evolve_batches(self, ctx: RoundCtx):
        """The mask-search batches, drawn from each client's stream right
        after its local-phase orders — the loop's ``evolve`` draw order."""
        bs = self.cfg.batch_size
        xs, ys = zip(*(c.sample_batch(ctx.client_rng(k), bs)
                       for k, c in enumerate(self.clients)))
        return self.task.as_tensor(np.stack(xs)), self.task.as_tensor(
            np.stack(ys))

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _round_phases(self, ctx: RoundCtx, phases: dict, tp: float) -> float:
        """The host inputs, then mix -> local phase -> evolve on the stacked
        state inside the ``scale.step`` span, with the step counters."""
        adapter = self.adapter
        bx, by, live = self._stacked_batches(
            ctx, range(len(self.clients)), self.cfg.local_epochs)
        ev = self._evolve_batches(ctx) if adapter.evolves else None
        counts = adapter.evolve_counts(ctx)
        tp = self._timed(phases, "inputs", tp)
        n_compiles = torch_compile_count()
        with span("scale.step", track="engine", round=ctx.t) as sp:
            state = adapter.stacked_mix(self.state, adapter.mix_matrix(ctx))
            tp = self._timed(phases, "mix", tp)
            params = stacked_local_phase(
                self.task.apply_fn, self._opt, state["params"],
                adapter.stacked_masks(state), bx, by, live, ctx.lr)
            state = {**state, "params": params}
            tp = self._timed(phases, "local", tp)
            if adapter.evolves:
                grads = stacked_grads(self.task.apply_fn, params, *ev)
                state = adapter.stacked_evolve(state, grads, counts)
            self.state = state
            tp = self._timed(phases, "evolve", tp)
            delta = torch_compile_count() - n_compiles
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
