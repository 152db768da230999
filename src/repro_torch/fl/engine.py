"""Round engine: strategy lifecycle hooks + streaming rounds, loop path
(reference ``repro.fl.engine``).

``RoundEngine`` owns the round loop — sample the topology, mix, run each
active client's local phase, evolve, evaluate on a cadence, account
comm/FLOPs — and a strategy supplies the hooks that differ
(``StrategyBase``).  ``engine.rounds()`` streams ``RoundMetrics``;
``engine.run()`` drains it into an ``FLResult``.

Determinism: all randomness comes from ``(cfg.seed, round, client, stream)``
through ``np.random.SeedSequence`` exactly as in the reference, so batch
orders, topologies and evolve batches replay the reference's draws, and a
resumed run is identical to an uninterrupted one.

Archives are the reference's (``save``/``restore``, lists stored under
``__list__`` keys): a reference engine archive loads here and this engine's
archives load into the reference.

Per-phase wall times (mix, local, evolve, eval), each ended by a device
synchronise, are kept in ``engine.phase_s``, one dict per round; the
phases are also ``round.*`` spans on the ``engine`` track, each closed
after its phase's synchronise, so on the card a span holds the device's
work and not only its launch.  ``engine.obs`` mirrors the reference's
``fl.engine`` gauges and ``engine.series`` samples its ``fl.engine``
series once per round.

Fast path: ``local_exec="vmap"`` (or ``"auto"`` where it applies) runs the
local phase of all active clients at once, one
``scale.stacked.stacked_sgd_step`` (``torch.func.vmap`` of ``grad``) a
step, masked when the strategy's ``local_mask`` is a tree and plain when
it is None, with batch orders drawn from the same per-client generators,
ragged step counts padded with exact no-op steps and momentum as stacked
per-client state, so the schedule and the update rule are the loop's.  The
step is compiled as the loop's is (``Task.local_step(opt, stacked=True)``
on the task's working buffers, the learning rate a device tensor), so its
captures depend on the number of active clients and the batch shape, not
on the phase's step count.

The engine keeps its clients' train and test sets on the device
(``data.loader.clients_on``), copied there once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import weakref
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.npz import load_pytree, save_pytree
from repro_torch.core.accounting import CommReport, FlopsReport
from repro_torch.core.evolve import cosine_prune_rate
from repro_torch.core.topology import make_adjacency
from repro_torch.data.loader import clients_on
from repro_torch.device import setup_device, synchronize
from repro_torch.fl.base import (
    FLConfig,
    FLResult,
    Task,
    _pad_order,
    evaluate_clients,
    rounds_to_targets,
)
from repro_torch.obs import CounterSet, SeriesSet, span
from repro_torch.optim.sgd import SGDConfig
from repro_torch.sparse.packed import pack_tree, unpack_mask_tree, unpack_tree
from repro_torch.utils.tree import (
    tree_map,
    tree_nnz,
    tree_size,
    tree_stack,
    tree_unstack,
)

PyTree = Any

# rng sub-streams (the last SeedSequence word), as in the reference; disjoint
# per use so adding a draw to one phase never perturbs another
STREAM_CLIENT = 0       # per-(round, client) training randomness
STREAM_ROUND = 1        # per-round strategy randomness (client selection)
STREAM_EVAL = 2         # per-(round, client) eval-time fine-tuning


def derive_rng(seed: int, round_idx: int, k: int = 0,
               stream: int = STREAM_CLIENT) -> np.random.Generator:
    """Order-independent generator for (seed, round, client, stream)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, round_idx, k, stream]))


@dataclasses.dataclass
class RoundCtx:
    """Everything a hook may need about the current round.  Generators are
    cached per round, so successive hook calls for one client continue one
    stream (mix draws, then local-phase draws, then evolve draws)."""
    t: int
    cfg: FLConfig
    task: Task
    clients: Sequence[Any]
    lr: float
    prune_rate: float
    adjacency: np.ndarray
    _rngs: dict = dataclasses.field(default_factory=dict, repr=False)

    def _rng(self, k: int, stream: int) -> np.random.Generator:
        key = (k, stream)
        if key not in self._rngs:
            self._rngs[key] = derive_rng(self.cfg.seed, self.t, k, stream)
        return self._rngs[key]

    def client_rng(self, k: int) -> np.random.Generator:
        return self._rng(k, STREAM_CLIENT)

    def round_rng(self) -> np.random.Generator:
        return self._rng(0, STREAM_ROUND)

    def eval_rng(self, k: int) -> np.random.Generator:
        return self._rng(k, STREAM_EVAL)


class StrategyBase:
    """Default hooks; subclass and override what differs.  ``init_state``
    returns the mutable, checkpointable state (nested dicts/lists of
    tensors); static derived quantities live on ``self`` and are re-derived
    by ``init_state`` on resume."""

    name: str = "strategy"
    #: the engine may run the local phase as vmap-over-clients when True
    vmap_capable: bool = False
    #: True iff ``mix`` communicates peer-to-peer over ``ctx.adjacency`` —
    #: the contract the network simulator (``repro_torch.sim``) measures
    decentralized: bool = False

    def init_state(self, task: Task, clients, cfg: FLConfig) -> dict:
        self.task, self.clients, self.cfg = task, clients, cfg
        self.opt = SGDConfig(momentum=cfg.momentum,
                             weight_decay=cfg.weight_decay)
        self.n_samples = int(np.mean([c.n_train for c in clients]))
        return {}

    def mix(self, state: dict, ctx: RoundCtx) -> None:
        """Communication phase."""

    def active_clients(self, state: dict, ctx: RoundCtx) -> Sequence[int]:
        return range(len(self.clients))

    def local_update(self, state: dict, k: int, ctx: RoundCtx) -> None:
        raise NotImplementedError

    def evolve(self, state: dict, k: int, ctx: RoundCtx) -> None:
        """Optional per-client mask search after the local phase."""

    def post_round(self, state: dict, ctx: RoundCtx) -> None:
        """Optional aggregation after all clients finished."""

    def eval_params(self, state: dict, ctx: RoundCtx) -> list[PyTree]:
        return state["params"]

    def finalize_eval_params(self, state: dict) -> list[PyTree]:
        return state["params"]

    def round_comm(self, state: dict, ctx: RoundCtx) -> CommReport:
        raise NotImplementedError

    def round_flops(self, state: dict, ctx: RoundCtx) -> FlopsReport:
        raise NotImplementedError

    # -- density telemetry: measured vs scheduled sparsity ------------------
    def measured_density(self, state: dict) -> Optional[float]:
        """Fleet-mean *measured* mask density (nnz / size over every
        client's mask, one read-back), or None for strategies without
        masks."""
        masks = state.get("masks") if isinstance(state, dict) else None
        if not masks or (isinstance(masks, list) and masks[0] is None):
            return None
        size = tree_size(masks)
        return float(tree_nnz(masks)) / float(size) if size else None

    def target_density(self, t: int) -> Optional[float]:
        """Fleet-mean *scheduled* density at round ``t``: the anneal
        schedule when the strategy has one (``density_at``), the static
        per-client config densities otherwise."""
        cfg = getattr(self, "cfg", None)
        if cfg is None:
            return None
        if hasattr(self, "density_at"):
            return float(np.mean([self.density_at(t, k)
                                  for k in range(cfg.n_clients)]))
        return float(np.mean([cfg.client_density(k)
                              for k in range(cfg.n_clients)]))

    # -- vmap fast-path adapters -------------------------------------------
    def local_epochs(self, state: dict, ctx: RoundCtx) -> int:
        return ctx.cfg.local_epochs

    def local_params(self, state: dict, k: int) -> PyTree:
        return state["params"][k]

    def local_mask(self, state: dict, k: int) -> Optional[PyTree]:
        return None

    def set_local(self, state: dict, k: int, params: PyTree) -> None:
        state["params"][k] = params

    def set_local_mask(self, state: dict, k: int, mask: PyTree) -> None:
        if mask is not None and "masks" in state:
            state["masks"][k] = mask

    # -- per-message payload (the simulator's bytes-on-wire) ----------------
    def message_nnz(self, state: dict, k: int) -> int:
        """Values client k puts on the wire: its mask's nnz, or the full
        coordinate count for dense strategies."""
        mask = self.local_mask(state, k)
        if mask is not None:
            return tree_nnz(mask)
        return tree_size(self.local_params(state, k))

    def message_coords(self, state: dict, k: int) -> int:
        return tree_size(self.local_params(state, k))

    def snapshot_message(self, state: dict, k: int) -> dict:
        """What k transmits right now: a packed tree (bitmap + nnz values),
        never the dense tree; dense strategies pack against an all-ones
        bitmap (``sim.links.measure_payload`` sizes it by the codec)."""
        return {"packed": pack_tree(self.local_params(state, k),
                                    self.local_mask(state, k))}

    def install_message(self, state: dict, k: int, msg: dict) -> None:
        """Write a received message into slot k (the simulator swaps these
        in so ``mix`` sees arrived, possibly stale, models)."""
        if "packed" in msg:
            self.set_local(state, k, unpack_tree(msg["packed"]))
            self.set_local_mask(state, k, unpack_mask_tree(msg["packed"]))
        else:
            self.set_local(state, k, msg["params"])
            self.set_local_mask(state, k, msg["mask"])

    def mix_one(self, state: dict, k: int, senders: dict[int, dict],
                ctx: RoundCtx) -> None:
        """Mix client k against the payloads that have *arrived* (the async
        simulator's per-activation hook).

        Generic fallback: swap the payloads into their slots, run the full
        ``mix`` on an adjacency whose only non-identity row is k's, keep
        only k's mixed model — right for any strategy, but O(K) tree work
        per activation; ``DisPFLStrategy`` overrides it with O(degree)
        packed folds."""
        if not senders:
            # gossip self-mix is the identity (re-masking a masked model)
            return
        saved_params = list(state["params"])
        saved_masks = list(state["masks"]) if "masks" in state else None
        for j, payload in senders.items():
            self.install_message(state, j, payload)
        self.mix(state, ctx)
        mixed_k = state["params"][k]
        state["params"] = saved_params
        state["params"][k] = mixed_k
        if saved_masks is not None:
            saved_masks[k] = state["masks"][k]
            state["masks"] = saved_masks


_REGISTRY: dict[str, tuple[type, dict]] = {}


def register(name: str, **defaults):
    """Class decorator: ``@register("dispfl")``."""

    def deco(cls):
        _REGISTRY[name] = (cls, dict(defaults))
        return cls

    return deco


def _ensure_zoo() -> None:
    """Import the built-in strategy modules so their @register calls run."""
    import repro_torch.fl.centralized  # noqa: F401
    import repro_torch.fl.decentralized  # noqa: F401
    import repro_torch.fl.dispfl  # noqa: F401
    import repro_torch.fl.partial  # noqa: F401


def strategy_names() -> list[str]:
    _ensure_zoo()
    return sorted(_REGISTRY)


def make_strategy(name: str, **overrides) -> StrategyBase:
    _ensure_zoo()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown strategy '{name}'; available: {sorted(_REGISTRY)}")
    cls, defaults = _REGISTRY[name]
    strat = cls(**{**defaults, **overrides})
    strat.name = name
    return strat


@dataclasses.dataclass
class RoundMetrics:
    round: int                       # 0-based round index
    lr: float
    prune_rate: float
    comm_busiest_mb: float           # this round, from the current adjacency
    comm_rows: dict
    flops_round: float               # per client, this round
    cum_flops: float                 # per client, cumulative
    acc_mean: Optional[float]        # None on non-eval rounds
    acc_std: Optional[float]
    wall_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Callback:
    def on_round_end(self, engine: "RoundEngine", metrics: RoundMetrics) -> None:
        pass

    def on_run_end(self, engine: "RoundEngine") -> None:
        pass


class JsonlLogger(Callback):
    """Append one JSON object per round; truncated when a run starts at
    round 0, so a resumed run keeps the rounds before the checkpoint."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def on_round_end(self, engine, metrics):
        mode = "w" if metrics.round == 0 else "a"
        with open(self.path, mode) as f:
            f.write(json.dumps(metrics.to_dict()) + "\n")


class Checkpointer(Callback):
    """Save the full engine state every ``every`` rounds (and at run end)."""

    def __init__(self, path: str, every: int = 1):
        self.path = path
        self.every = max(1, every)

    def on_round_end(self, engine, metrics):
        if (metrics.round + 1) % self.every == 0:
            engine.save(self.path)

    def on_run_end(self, engine):
        engine.save(self.path)


class EarlyStopAtTarget(Callback):
    """Stop once mean personalized accuracy reaches ``target``."""

    def __init__(self, target: float):
        self.target = target

    def on_round_end(self, engine, metrics):
        if metrics.acc_mean is not None and metrics.acc_mean >= self.target:
            engine.request_stop()


# lists <-> marked dicts, so '/'-joined archive paths round-trip (the
# reference's layout, fl/engine.py _pack/_unpack)
_LIST_KEY = "__list__"


def _pack(tree):
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {_LIST_KEY: {f"{i:06d}": _pack(v) for i, v in enumerate(tree)}}
    return tree


def _unpack(tree):
    if isinstance(tree, dict):
        if set(tree.keys()) == {_LIST_KEY}:
            inner = tree[_LIST_KEY]
            return [_unpack(inner[k]) for k in sorted(inner)]
        return {k: _unpack(v) for k, v in tree.items()}
    return tree


class RoundEngine:
    """Owns the round loop for any strategy, on ``task.device``.

    ``local_exec``:

    * ``"loop"`` — per-client loop (the reference semantics),
    * ``"vmap"`` — force the stacked local phase (``ValueError`` if the
      strategy or config cannot take it),
    * ``"auto"`` — vmap when the strategy is vmap-capable, densities are
      homogeneous and all active clients agree on an effective batch size;
      loop otherwise.
    """

    def __init__(self, strategy: StrategyBase, task: Task, clients,
                 cfg: FLConfig, callbacks: Sequence[Callback] = (),
                 local_exec: str = "auto"):
        if local_exec not in ("auto", "loop", "vmap"):
            raise ValueError(f"local_exec must be auto|loop|vmap, got {local_exec}")
        self.device = setup_device(task.device)
        self.strategy = strategy
        self.task = task
        self.clients = clients_on(clients, self.device)
        self.cfg = cfg
        self.callbacks = list(callbacks)
        self.local_exec = local_exec
        self.state = strategy.init_state(task, self.clients, cfg)
        self._next_round = 0
        self._stop = False
        self._acc_history: list[float] = []
        self._acc_stds: list[float] = []
        self._eval_rounds: list[int] = []
        self._comm: dict[str, list[float]] = {
            "busiest_mb": [], "avg_per_node_mb": [], "total_mb": [],
            "busiest_mb_with_bitmap": []}
        self._flops: dict[str, list[float]] = {
            "per_round_flops": [], "dense_per_round_flops": [],
            "fwd_flops_per_sample": []}
        #: per round: seconds in each phase, each ended by a device sync
        self.phase_s: list[dict[str, float]] = []
        # the gauges hold the engine weakly: a strong reference would make
        # a cycle that keeps the engine's state alive until Python's cyclic
        # collector runs
        me = weakref.ref(self)
        self.obs = CounterSet("fl.engine")
        self.obs.gauge("rounds_completed", fn=lambda: me()._next_round)
        self.obs.gauge("cum_flops", fn=lambda: float(
            np.sum(me()._flops["per_round_flops"])))
        self.obs.gauge("comm_total_mb", fn=lambda: float(
            np.sum(me()._comm["total_mb"])))
        # per-round wall-clock series (not checkpointed: a resumed run
        # restarts its series)
        self.series = SeriesSet("fl.engine")
        self._series_epoch = time.perf_counter()

    def request_stop(self) -> None:
        self._stop = True

    # -- checkpointing -----------------------------------------------------
    def _checkpoint_payload(self) -> dict:
        """The full serializable engine state (subclasses extend or reshape
        it: ``ScaleEngine`` writes its stacked state as per-client lists)."""
        return {
            "engine": {
                "next_round": np.asarray(self._next_round, np.int64),
                "acc_history": np.asarray(self._acc_history, np.float64),
                "acc_stds": np.asarray(self._acc_stds, np.float64),
                "eval_rounds": np.asarray(self._eval_rounds, np.int64),
                "comm": {k: np.asarray(v, np.float64)
                         for k, v in self._comm.items()},
                "flops": {k: np.asarray(v, np.float64)
                          for k, v in self._flops.items()},
            },
            "state": _pack(self.state),
        }

    def save(self, path: str) -> None:
        save_pytree(path, self._checkpoint_payload())

    def restore(self, path: str) -> "RoundEngine":
        """Load an archive written by this engine or the reference's."""
        self._restore_payload(load_pytree(path))
        return self

    def _restore_payload(self, payload: dict) -> None:
        eng = payload["engine"]
        self._next_round = int(eng["next_round"])
        self._acc_history = [float(a) for a in eng["acc_history"]]
        self._acc_stds = [float(a) for a in eng["acc_stds"]]
        self._eval_rounds = [int(r) for r in eng["eval_rounds"]]
        self._comm = {k: [float(x) for x in v] for k, v in eng["comm"].items()}
        self._flops = {k: [float(x) for x in v]
                       for k, v in eng["flops"].items()}
        self.state = tree_map(
            lambda a: torch.as_tensor(a).to(self.device),
            _unpack(payload["state"]))

    # -- the round loop ----------------------------------------------------
    def _make_ctx(self, t: int, alive: Optional[np.ndarray] = None) -> RoundCtx:
        cfg = self.cfg
        return RoundCtx(
            t=t, cfg=cfg, task=self.task, clients=self.clients,
            lr=cfg.lr_at(t),
            prune_rate=cosine_prune_rate(cfg.alpha0, t, cfg.rounds),
            adjacency=make_adjacency(cfg.topology, len(self.clients), t,
                                     cfg.degree, cfg.seed, cfg.drop_prob,
                                     alive=alive))

    # hooks for subclasses (the event simulator times each round without
    # perturbing the round's semantics)
    def _pre_round(self, ctx: RoundCtx) -> None:
        """Called after the ctx is built, before any hook runs."""

    def _finish_metrics(self, ctx: RoundCtx,
                        metrics: RoundMetrics) -> RoundMetrics:
        """Last chance to decorate the round's metrics before callbacks."""
        return metrics

    def _sample_series(self, metrics: RoundMetrics) -> None:
        """Sample the wall-clock engine series after one round.  Counter-kind
        series record the *cumulative* accumulators."""
        tw = time.perf_counter() - self._series_epoch
        ss = self.series
        ss.series("round_wall_s").observe(tw, metrics.wall_s)
        ss.series("comm_total_mb", kind="counter").observe(
            tw, float(np.sum(self._comm["total_mb"])))
        ss.series("cum_flops", kind="counter").observe(tw, metrics.cum_flops)
        if metrics.acc_mean is not None:
            ss.series("acc_mean").observe(tw, metrics.acc_mean)
        dm = self.strategy.measured_density(self.state)
        if dm is not None:
            ss.series("density_measured").observe(tw, dm)
            dt_ = self.strategy.target_density(metrics.round)
            if dt_ is not None:
                ss.series("density_target").observe(tw, dt_)

    def run_local_phase(self, ctx: RoundCtx, active: Sequence[int]) -> None:
        """The local phase for ``active`` clients — the unit the simulator
        runs per client (``active=[k]``) or per round."""
        active = list(active)
        if self._use_vmap(ctx, active):
            self._vmap_local_phase(ctx, active)
        else:
            for k in active:
                self.strategy.local_update(self.state, k, ctx)

    def _timed(self, phases: dict, name: str, t0: float) -> float:
        synchronize(self.device)
        t1 = time.perf_counter()
        phases[name] = t1 - t0
        return t1

    def _round_phases(self, ctx: RoundCtx, phases: dict, tp: float) -> float:
        """mix -> local -> evolve through the strategy's hooks, each phase
        timed into ``phases`` inside its span; returns the clock after the
        last."""
        strat = self.strategy
        with span("round.mix", track="engine", round=ctx.t):
            strat.mix(self.state, ctx)
            tp = self._timed(phases, "mix", tp)
        active = list(strat.active_clients(self.state, ctx))
        with span("round.local", track="engine", round=ctx.t,
                  active=len(active)):
            self.run_local_phase(ctx, active)
            tp = self._timed(phases, "local", tp)
        with span("round.evolve", track="engine", round=ctx.t):
            for k in active:
                strat.evolve(self.state, k, ctx)
            strat.post_round(self.state, ctx)
            return self._timed(phases, "evolve", tp)

    def _round_accounting(self, ctx: RoundCtx):
        """(CommReport, FlopsReport) of the round just run."""
        return (self.strategy.round_comm(self.state, ctx),
                self.strategy.round_flops(self.state, ctx))

    def _eval_accs(self, ctx: RoundCtx) -> list[float]:
        return evaluate_clients(
            self.task, self.strategy.eval_params(self.state, ctx),
            self.clients)

    def _run_one_round(self, t: int) -> RoundMetrics:
        cfg = self.cfg
        phases: dict[str, float] = {}
        synchronize(self.device)
        t0 = tp = time.perf_counter()
        ctx = self._make_ctx(t)
        self._pre_round(ctx)
        tp = self._round_phases(ctx, phases, tp)

        comm, flops = self._round_accounting(ctx)
        for key in self._comm:
            self._comm[key].append(float(getattr(comm, key)))
        for key in self._flops:
            self._flops[key].append(float(getattr(flops, key)))

        acc_mean = acc_std = None
        if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
            with span("round.eval", track="engine", round=t):
                accs = self._eval_accs(ctx)
            acc_mean = float(np.mean(accs))
            acc_std = float(np.std(accs))
            self._acc_history.append(acc_mean)
            self._acc_stds.append(acc_std)
            self._eval_rounds.append(t)
        tp = self._timed(phases, "eval", tp)
        self.phase_s.append(phases)

        self._next_round = t + 1
        metrics = RoundMetrics(
            round=t, lr=ctx.lr, prune_rate=ctx.prune_rate,
            comm_busiest_mb=comm.busiest_mb, comm_rows=comm.row(),
            flops_round=flops.per_round_flops,
            cum_flops=float(np.sum(self._flops["per_round_flops"])),
            acc_mean=acc_mean, acc_std=acc_std, wall_s=tp - t0)
        metrics = self._finish_metrics(ctx, metrics)
        self._sample_series(metrics)
        return metrics

    def rounds(self) -> Iterator[RoundMetrics]:
        for t in range(self._next_round, self.cfg.rounds):
            metrics = self._run_one_round(t)
            for cb in self.callbacks:
                cb.on_round_end(self, metrics)
            yield metrics
            if self._stop:
                break
        for cb in self.callbacks:
            cb.on_run_end(self)

    # -- results -----------------------------------------------------------
    def _final_accs(self) -> list[float]:
        """Per-client personalized accuracy of the final models."""
        return evaluate_clients(
            self.task, self.strategy.finalize_eval_params(self.state),
            self.clients)

    def result(self, targets: Sequence[float] = (0.5,)) -> FLResult:
        """Paper-table ``FLResult``; comm/FLOP columns are means over the
        executed rounds."""
        final = self._final_accs()
        comm = CommReport(**{k: float(np.mean(v)) if v else 0.0
                             for k, v in self._comm.items()})
        flops = FlopsReport(**{k: float(np.mean(v)) if v else 0.0
                               for k, v in self._flops.items()})
        return FLResult(
            acc_history=list(self._acc_history),
            final_accs=final,
            comm_busiest_mb=comm.busiest_mb, comm_rows=comm.row(),
            flops_per_round=flops.per_round_flops, flops_rows=flops.row(),
            rounds_to=rounds_to_targets(self._acc_history, list(targets)))

    def run(self, targets: Sequence[float] = (0.5,)) -> FLResult:
        for _ in self.rounds():
            pass
        return self.result(targets)

    # -- vmap fast path ----------------------------------------------------
    def _use_vmap(self, ctx: RoundCtx, active: list[int]) -> bool:
        if self.local_exec == "loop" or not active:
            return False
        ok, why = self._vmap_supported(ctx, active)
        if self.local_exec == "vmap" and not ok:
            raise ValueError(f"local_exec='vmap' requested but {why}")
        return ok

    def _vmap_supported(self, ctx: RoundCtx, active: list[int]):
        cfg = self.cfg
        if not self.strategy.vmap_capable:
            return False, f"strategy '{self.strategy.name}' is not vmap-capable"
        if cfg.capacities is not None:
            return False, "heterogeneous capacities use the per-client loop"
        ns = [self.clients[k].n_train for k in active]
        bss = {min(cfg.batch_size, n) for n in ns}
        if len(bss) != 1:
            return False, "clients disagree on effective batch size"
        # ragged step counts are fine: the stacked phase pads every client to
        # the max step count and masks the padded updates (no-op steps)
        return True, ""

    def _stacked_batches(self, ctx: RoundCtx, active: Sequence[int],
                         epochs: int, keep: Optional[range] = None):
        """(bx, by, live) of the stacked local phase of ``active`` on the
        device: one permutation per epoch from each client's ``(seed,
        round, k)`` generator — the loop's draws — padded to the longest
        schedule with recycled batches, ``live`` marking the real steps
        (padded steps are exact no-ops).  ``keep`` (positions in
        ``active``) takes only those clients' batches to the device, after
        every client's draws."""
        bs = min(self.cfg.batch_size,
                 min(self.clients[k].n_train for k in active))
        orders = []
        for k in active:
            rng = ctx.client_rng(k)
            orders.append(np.concatenate(
                [_pad_order(self.clients[k].n_train, bs, rng)
                 for _ in range(epochs)]))
        s_max = max(len(o) // bs for o in orders)
        keep = range(len(active)) if keep is None else keep
        own = [active[i] for i in keep]
        orders = [orders[i] for i in keep]
        # every client's padded order in one copy, its batches gathered on
        # the device from its own train set
        idx = self.task.as_tensor(
            np.stack([np.resize(o, s_max * bs) for o in orders]))
        xb = torch.stack([self.clients[k].train_x[i]
                          for k, i in zip(own, idx)])
        yb = torch.stack([self.clients[k].train_y[i]
                          for k, i in zip(own, idx)])
        live = self.task.as_tensor(np.stack(
            [np.arange(s_max) < len(o) // bs for o in orders]))
        return (xb.reshape((len(own), s_max, bs) + xb.shape[2:]),
                yb.reshape(len(own), s_max, bs), live)

    def _vmap_local_phase(self, ctx: RoundCtx, active: list[int]) -> None:
        strat = self.strategy
        state = self.state
        bx, by, live = self._stacked_batches(
            ctx, active, strat.local_epochs(state, ctx))
        masks = [strat.local_mask(state, k) for k in active]
        work = self.task.working_buffers(
            tree_stack([strat.local_params(state, k) for k in active]),
            None if masks[0] is None else tree_stack(masks),
            strat.opt, ctx.lr, bx[:, 0], by[:, 0], live[:, 0])
        step = self.task.local_step(strat.opt, stacked=True)
        w, st = work["w"], work["st"]
        for s in range(bx.shape[1]):
            work["x"].copy_(bx[:, s])
            work["y"].copy_(by[:, s])
            work["alive"].copy_(live[:, s])
            w, st = step(w, st, work["m"], work["x"], work["y"], work["lr"],
                         work["alive"])
        # the working buffers outlive the phase: copy the result out
        new = tree_map(torch.clone, w)
        for k, params in zip(active, tree_unstack(new, len(active))):
            strat.set_local(state, k, params)


def run_strategy(name: str, task: Task, clients, cfg: FLConfig,
                 targets: Sequence[float] = (0.5,),
                 callbacks: Sequence[Callback] = (),
                 local_exec: str = "auto", **strategy_kw) -> FLResult:
    """Build the named strategy, run it through the engine, return the
    ``FLResult``."""
    engine = RoundEngine(make_strategy(name, **strategy_kw), task, clients,
                         cfg, callbacks=callbacks, local_exec=local_exec)
    return engine.run(targets)
