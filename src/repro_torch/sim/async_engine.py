"""Event-driven simulator for decentralized sparse training, fault-realistic
(reference ``repro.sim.async_engine``, ported line for line).

``SimEngine`` drives the *existing* ``Strategy`` hook classes (no strategy
changes) through a discrete-event timeline with per-edge link models
(``sim.links``), per-client compute speeds (``sim.events.ComputeModel``) and
client up/down schedules (``sim.availability``).  Two modes:

* ``mode="sync"`` — the synchronous barrier protocol.  State evolution is
  *bit-identical* to ``RoundEngine`` (it runs the exact same round body via
  the engine's ``_run_one_round``); the simulator only adds a virtual
  timeline on top: per-round duration = slowest client's compute + its
  slowest transfer, every mix-phase message measured on the wire from the
  sender's current mask nnz.

* ``mode="async"`` — staleness-aware asynchronous push-gossip.  Each client
  runs its own local-round clock: wake, mix whatever neighbor payloads have
  *arrived* by now via the per-client ``Strategy.mix_one`` hook (O(degree)
  packed folds for the decentralized strategies, generic O(K) swap
  fallback otherwise), train for ``flops / (flops_per_s * speed_k)``
  virtual seconds, push the updated *packed* sparse model to ``degree``
  sampled receivers (transfer time from the link model, payload sized by
  the wire codec), sleep until the sends are scheduled, repeat.  ``staleness >= 0`` enforces the
  bounded-staleness (stale-synchronous-parallel) protocol: no client may run
  more than ``staleness`` rounds ahead of the slowest, and messages older
  than the bound are not mixed; ``staleness < 0`` is fully asynchronous.
  ``staleness=0`` degenerates to a barrier.

Fault realism (v2):

* **Shared uplinks** — ``uplink="fifo"`` / ``"fair"`` serializes a sender's
  concurrent transfers on one uplink (``sim.links.UplinkScheduler``)
  instead of running every edge in parallel, which stretches busiest-node
  timelines exactly where the paper's headline metric lives.
* **Message loss + retransmit** — a ``sim.links.LossModel`` drops messages
  per-link with derived-rng Bernoulli draws; the sender retransmits after a
  timeout and every attempt's bytes are measured on the wire.  In sync mode
  the barrier's transport is *reliable*: the drop draws only decide how
  many transmissions the timeline and byte counters record (state evolution
  stays bit-identical to ``RoundEngine``); in async mode a message that
  exhausts its retransmit budget is really lost — the receiver just never
  mixes it.
* **Trace-driven bandwidth** — a ``sim.links.BandwidthTrace`` on the
  ``LinkModel`` scales link rates over virtual time.
* **Checkpoint/resume** — ``save``/``restore`` round-trip the *complete*
  simulation through ``checkpoint.npz`` and ``checkpoint.packed``: virtual clock, pending event
  queue (with in-flight packed payloads), per-client local clocks and
  inboxes, ``LinkStats``, uplink busy-until state and accuracy traces.  A
  run checkpointed at any round (sync) or any emitted round mid-event-loop
  (async) and resumed is bit-identical to the uninterrupted run — every
  tie-break survives because event insertion sequences are persisted, and
  all randomness (training, topology, loss) is derived per (seed, ...)
  rather than carried in generator objects.

Worked example::

    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import make_strategy
    from repro_torch.sim import ComputeModel, LinkModel, LossModel, SimEngine

    clients, _ = build_federated_image_task(0, n_clients=8)
    task = make_cnn_task("smallcnn")            # on CUDA; device="cpu" else
    cfg = FLConfig(n_clients=8, rounds=20, degree=3)
    eng = SimEngine(make_strategy("dispfl"), task, clients, cfg,
                    mode="async", staleness=2,
                    links=LinkModel.skewed(8, mbps=100, skew=10),
                    compute=ComputeModel.heterogeneous(8),
                    uplink="fifo", loss=LossModel(0.1, timeout_s=0.5))
    for m in eng.rounds():          # SimRoundMetrics: acc + virtual time
        print(m.round, m.acc_mean, m.sim_time_s)
    print(eng.report().to_dict())   # wall-clock-to-target, busiest node, ...

On the card the state lives on ``task.device``: sync mode mixes through
the gossip kernel (and the packed fold, decoding each payload), async mode
folds each arrived payload leaf with the packed-fold kernel
(``DisPFLStrategy.mix_one``).  Payloads are device tensors; they reach the
host only when a checkpoint writes them.

Determinism: all training randomness is derived per (seed, local round,
client) exactly as in ``RoundEngine``; event ties break on insertion order;
there is no wall-clock anywhere in the virtual timeline — a simulation is a
pure function of (strategy, data, cfg, links, compute, availability, loss).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.checkpoint.packed import decode_packed, encode_packed
from repro_torch.core.accounting import edge_message_bytes
from repro_torch.core.evolve import cosine_prune_rate
from repro_torch.core.topology import directed_out_neighbors
from repro_torch.fl.base import evaluate_clients
from repro_torch.fl.engine import (
    RoundCtx,
    RoundEngine,
    RoundMetrics,
    StrategyBase,
    _pack,
    _unpack,
)
from repro_torch.obs import VIRTUAL, SeriesSet, get_tracer
from repro_torch.sim.availability import AlwaysUp, Availability
from repro_torch.sim.events import (
    ARRIVAL,
    DONE,
    WAKE,
    ComputeModel,
    Event,
    EventQueue,
    VirtualClock,
)
from repro_torch.sim.links import (
    MB,
    LinkModel,
    LinkStats,
    LossModel,
    UplinkScheduler,
    measure_payload,
)
from repro_torch.sim.report import SimReport, build_report

_KIND_CODES = {WAKE: 0, ARRIVAL: 1, DONE: 2}
_CODE_KINDS = {v: k for k, v in _KIND_CODES.items()}
_MODE_CODES = {"sync": 0, "async": 1}
_SIM_CKPT_VERSION = 1


@dataclasses.dataclass
class SimRoundMetrics(RoundMetrics):
    """RoundMetrics + the virtual timeline (JSONL-streams through the same
    callback protocol — ``to_dict`` inherits)."""
    sim_time_s: float = 0.0          # virtual clock after this round
    sim_round_s: float = 0.0         # this round's virtual duration
    measured_total_mb: float = 0.0   # cumulative measured bytes-on-wire
    busiest_up_mb: float = 0.0       # cumulative, busiest node convention
    busiest_down_mb: float = 0.0
    min_round: int = 0               # async: slowest / fastest client rounds
    max_round: int = 0
    retrans_mb: float = 0.0          # cumulative retransmitted value-MB
    lost_messages: int = 0           # cumulative undelivered messages (async)


@dataclasses.dataclass
class _Message:
    """A published model.  ``version`` counts completed rounds: the model a
    sender publishes after finishing round t has version t+1, so a receiver
    at round t mixing a version-t model sees lag 0 — exactly the freshness
    the synchronous protocol provides (mix at round t uses end-of-round-t-1
    models).  The staleness bound filters on this lag."""
    version: int
    payload: dict       # StrategyBase.snapshot_message


@dataclasses.dataclass
class _AsyncState:
    """The complete mutable state of one asynchronous event loop — held on
    the engine (not in generator locals) so ``save`` can serialize a
    *mid-run* simulation and ``restore`` can resume it bit-identically."""
    q: EventQueue
    inbox: list                      # per client: {src: _Message}
    t_local: np.ndarray              # completed local rounds per client
    down_count: np.ndarray           # total down slots (slot offset)
    down_streak: np.ndarray          # consecutive down retries
    waiting: set                     # SSP-blocked clients
    done: set
    dead: set                        # exhausted max_down_retries
    emitted: int = 0                 # global rounds yielded so far
    last_finish: float = 0.0
    prev_snap: Optional[dict] = None # LinkStats snapshot at last emission


class SimEngine(RoundEngine):
    """Discrete-event wrapper around the Strategy hook protocol."""

    def __init__(self, strategy: StrategyBase, task, clients, cfg,
                 callbacks: Sequence = (), local_exec: str = "auto",
                 mode: str = "sync", staleness: int = 0,
                 links: Optional[LinkModel] = None,
                 compute: Optional[ComputeModel] = None,
                 availability: Optional[Availability] = None,
                 round_s: Optional[float] = None,
                 compute_speeds: Optional[np.ndarray] = None,
                 max_down_retries: int = 100,
                 uplink: str = "parallel",
                 loss: Optional[LossModel] = None):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be sync|async, got {mode}")
        super().__init__(strategy, task, clients, cfg,
                         callbacks=callbacks, local_exec=local_exec)
        n = len(clients)
        self.mode = mode
        self.staleness = int(staleness)
        #: async: consecutive down-slot retries before a client is declared
        #: dead (stops participating and no longer bounds SSP progress)
        self.max_down_retries = int(max_down_retries)
        self.links = links or LinkModel.uniform(n)
        self.availability = availability or AlwaysUp(n)
        self.uplink = UplinkScheduler(n, uplink)
        self.loss = loss
        if compute is None:
            if round_s is not None:
                # anchor the timescale: a speed-1.0 client does one local
                # round (at this strategy's analytic FLOPs) in round_s
                compute = ComputeModel.paced(
                    n, self.round_flops_estimate(), round_s,
                    speeds=compute_speeds)
            elif compute_speeds is not None:
                compute = ComputeModel(speeds=compute_speeds)
            else:
                compute = ComputeModel.uniform(n)
        self.compute = compute
        self.clock = VirtualClock()
        self.stats = LinkStats(n)
        self.acc_trace: list[tuple[float, float]] = []   # (virtual s, acc)
        # obs layer 2: virtual-clock fleet series, sampled once per emitted
        # round (not checkpointed — LinkStats stays the source of truth)
        self.sim_series = SeriesSet("sim.engine")
        # async invariant observability
        self.observed_spread = 0          # max t_k - min(t) at execution
        self.observed_mix_lag = 0         # max version lag actually mixed
        self.mixed_messages = 0           # neighbor models mixed over the run
        self._pending_edges = None        # sync: this round's message sizes
        self._as: Optional[_AsyncState] = None   # async event-loop state
        # trace-only transient: virtual time each SSP-blocked client started
        # waiting (not checkpointed — resumed runs restart open waits)
        self._wait_since: dict[int, float] = {}

    # ------------------------------------------------------------------
    # shared
    # ------------------------------------------------------------------
    @property
    def sim_time(self) -> float:
        return self.clock.now

    def round_flops_estimate(self) -> float:
        """Analytic per-client FLOPs of one local round (round 0)."""
        ctx = self._make_ctx(0)
        return float(self.strategy.round_flops(self.state, ctx).per_round_flops)

    def report(self, targets: Sequence[float] = ()) -> SimReport:
        return build_report(self.mode, self.stats, self.acc_trace,
                            self.clock.now, targets)

    def _make_ctx(self, t: int, alive: Optional[np.ndarray] = None) -> RoundCtx:
        if alive is None and not self.availability.always_up:
            alive = self.availability.alive(t)
        return super()._make_ctx(t, alive=alive)

    # ------------------------------------------------------------------
    # transfers: shared uplink + loss/retransmit (both modes)
    # ------------------------------------------------------------------
    def _trace_xfer(self, src: int, dst: int, bytes_v: float, bytes_w: float,
                    t_start: float, t_end: float, attempt: int) -> None:
        """Mirror one ``LinkStats.record`` as virtual-clock trace spans —
        same floats, so trace spans reconcile with the transfer log
        bit-for-bit.  A per-edge span on ``link/src->dst`` plus, under a
        shared-uplink discipline, the serialization slot on ``uplink/src``
        (the arrival minus propagation latency is when the uplink frees)."""
        tr = get_tracer()
        if not tr.enabled:
            return
        tr.add_span("retransmit" if attempt else "transfer",
                    t_start, t_end, track=f"link/{src}->{dst}", clock=VIRTUAL,
                    src=src, dst=dst, bytes_values=bytes_v,
                    bytes_wire=bytes_w, attempt=attempt)
        if self.uplink.mode != "parallel":
            tr.add_span("uplink.busy", t_start,
                        t_end - float(self.links.latency_s[src, dst]),
                        track=f"uplink/{src}", clock=VIRTUAL, dst=dst)

    def _transmit(self, src: int, jobs: list[tuple[int, float, float]],
                  t_request: float, tag: int,
                  reliable: bool) -> list[tuple[int, bool, float]]:
        """Put ``jobs`` = [(dst, value_bytes, wire_bytes), ...] on ``src``'s
        uplink at ``t_request``; apply the loss model per edge, scheduling
        each retransmit ``timeout_s`` after the previous attempt left the
        uplink.  Every attempt is recorded in ``LinkStats``.  Returns one
        (dst, delivered, t_last_arrival) per job; with ``reliable=True``
        (sync barrier) the final attempt always delivers."""
        slots = self.uplink.schedule(
            self.links, src, [(d, w) for d, _v, w in jobs], t_request)
        out = []
        for (dst, bytes_v, bytes_w), (t_start, t_end) in zip(jobs, slots):
            attempts, delivered = (self.loss.attempts(src, dst, tag)
                                   if self.loss is not None else (1, True))
            self.stats.record(src, dst, bytes_v, bytes_w, t_start, t_end,
                              attempt=0)
            self._trace_xfer(src, dst, bytes_v, bytes_w, t_start, t_end, 0)
            end = t_end
            for a in range(1, attempts):
                t_retry = (end - float(self.links.latency_s[src, dst])
                           + self.loss.timeout_s)
                (t2, e2), = self.uplink.schedule(
                    self.links, src, [(dst, bytes_w)], t_retry)
                self.stats.record(src, dst, bytes_v, bytes_w, t2, e2,
                                  attempt=a)
                self._trace_xfer(src, dst, bytes_v, bytes_w, t2, e2, a)
                end = e2
            if reliable:
                delivered = True
            if not delivered:
                self.stats.record_lost(src, dst)
            out.append((dst, delivered, end))
        return out

    def _sample_sim_series(self) -> None:
        """One virtual-clock sample of the fleet series.  The cumulative
        counter-kind byte samples reconcile exactly with the ``sim.links``
        gauges in ``snapshot_counters()`` (same accumulators)."""
        t = self.clock.now
        ss = self.sim_series
        ss.series("busiest_mb", clock=VIRTUAL).observe(
            t, float(np.maximum(self.stats.up, self.stats.down).max()) * MB)
        ss.series("bytes_values", clock=VIRTUAL, kind="counter").observe(
            t, float(self.stats.up.sum()))
        ss.series("bytes_wire", clock=VIRTUAL, kind="counter").observe(
            t, float(self.stats.up_wire.sum()))
        ss.series("n_retransmits", clock=VIRTUAL, kind="counter").observe(
            t, float(self.stats.n_retransmits))

    def _end_waits(self, ks, t_now: float) -> None:
        """Close ``ssp.wait`` spans for clients unblocked at ``t_now``."""
        tr = get_tracer()
        for k in ks:
            t0 = self._wait_since.pop(int(k), None)
            if t0 is not None and tr.enabled:
                tr.add_span("ssp.wait", t0, t_now, track=f"client/{int(k)}",
                            clock=VIRTUAL)

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def _checkpoint_payload(self) -> dict:
        payload = super()._checkpoint_payload()
        sim = {
            "version": np.asarray(_SIM_CKPT_VERSION, np.int64),
            "mode": np.asarray(_MODE_CODES[self.mode], np.int64),
            "clock_now": np.asarray(self.clock.now, np.float64),
            "acc_trace": np.asarray(self.acc_trace,
                                    np.float64).reshape(-1, 2),
            "observed": np.asarray(
                [self.observed_spread, self.observed_mix_lag,
                 self.mixed_messages], np.int64),
            "uplink": self.uplink.state_dict(),
            "stats": self.stats.state_dict(),
        }
        if self._as is not None:
            sim["async"] = self._pack_async_state(self._as)
        payload["sim"] = sim
        return payload

    def _restore_payload(self, payload: dict) -> None:
        if "sim" not in payload:
            raise ValueError(
                "not a SimEngine checkpoint (no virtual timeline inside); "
                "resume it with RoundEngine, or re-save through SimEngine")
        super()._restore_payload(payload)
        sim = payload["sim"]
        ck_mode = int(sim["mode"])
        if ck_mode != _MODE_CODES[self.mode]:
            names = {v: k for k, v in _MODE_CODES.items()}
            raise ValueError(
                f"checkpoint was written by a mode={names[ck_mode]!r} "
                f"simulation; this engine is mode={self.mode!r}")
        self.clock = VirtualClock()
        self.clock.advance_to(float(sim["clock_now"]))
        trace = np.asarray(sim["acc_trace"], dtype=np.float64).reshape(-1, 2)
        self.acc_trace = [(float(t), float(a)) for t, a in trace]
        obs = np.asarray(sim["observed"], dtype=np.int64)
        self.observed_spread = int(obs[0])
        self.observed_mix_lag = int(obs[1])
        self.mixed_messages = int(obs[2])
        self.uplink.load_state(sim["uplink"])
        self.stats.load_state(sim["stats"])
        if self.mode == "async":
            if "async" not in sim:
                raise ValueError(
                    "async checkpoint is missing its event-loop state")
            self._as = self._unpack_async_state(sim["async"])

    def _pack_async_state(self, st: _AsyncState) -> dict:
        n = len(self.clients)
        events = st.q.pending()
        # one push shares a single payload object across up to `degree`
        # ARRIVAL events and inbox slots — serialize each unique payload
        # once (pool index by object identity) instead of per occurrence
        pool: dict = {}
        pool_ids: dict[int, int] = {}

        def payload_ref(payload: dict) -> int:
            idx = pool_ids.get(id(payload))
            if idx is None:
                idx = len(pool_ids)
                pool_ids[id(payload)] = idx
                pool[f"{idx:06d}"] = _pack(encode_packed(payload))
            return idx

        ev = {
            "time": np.asarray([e.time for e in events], np.float64),
            "seq": np.asarray([e.seq for e in events], np.int64),
            "kind": np.asarray([_KIND_CODES[e.kind] for e in events],
                               np.int64),
            "k": np.asarray([e.data["k"] for e in events], np.int64),
            "src": np.asarray([e.data.get("src", -1) for e in events],
                              np.int64),
            "msg_version": np.asarray(
                [e.data["msg"].version if "msg" in e.data else -1
                 for e in events], np.int64),
            "msg_payload": np.asarray(
                [payload_ref(e.data["msg"].payload) if "msg" in e.data
                 else -1 for e in events], np.int64),
        }
        inbox = {}
        for k in range(n):
            slot = {}
            for j, msg in st.inbox[k].items():
                slot[f"{j:04d}"] = {
                    "v": np.asarray(msg.version, np.int64),
                    "pid": np.asarray(payload_ref(msg.payload), np.int64),
                }
            inbox[f"{k:04d}"] = slot
        flags = np.zeros((3, n), dtype=bool)
        for row, group in enumerate((st.waiting, st.done, st.dead)):
            for k in group:
                flags[row, k] = True
        return {
            "events": ev,
            "payloads": pool,
            "inbox": inbox,
            "t_local": st.t_local.astype(np.int64),
            "down_count": st.down_count.astype(np.int64),
            "down_streak": st.down_streak.astype(np.int64),
            "flags": flags,
            "emitted": np.asarray(st.emitted, np.int64),
            "last_finish": np.asarray(st.last_finish, np.float64),
            "prev_snap": {k: np.asarray(v, np.float64)
                          for k, v in (st.prev_snap or {}).items()},
        }

    def _unpack_async_state(self, d: dict) -> _AsyncState:
        n = len(self.clients)
        ev = d["events"]
        times = np.asarray(ev["time"], np.float64)
        seqs = np.asarray(ev["seq"], np.int64)
        kinds = np.asarray(ev["kind"], np.int64)
        ks = np.asarray(ev["k"], np.int64)
        srcs = np.asarray(ev["src"], np.int64)
        versions = np.asarray(ev["msg_version"], np.int64)
        pids = np.asarray(ev["msg_payload"], np.int64)
        # decode the payload pool once; every referencing event/inbox slot
        # shares the decoded object, exactly like the live broadcast did
        pool = {int(key): decode_packed(_unpack(tree), self.device)
                for key, tree in d.get("payloads", {}).items()}
        events = []
        for i in range(len(times)):
            data = {"k": int(ks[i])}
            if int(kinds[i]) == _KIND_CODES[ARRIVAL]:
                data["src"] = int(srcs[i])
                data["msg"] = _Message(version=int(versions[i]),
                                       payload=pool[int(pids[i])])
            events.append(Event(float(times[i]), int(seqs[i]),
                                _CODE_KINDS[int(kinds[i])], data))
        q = EventQueue()
        q.restore(events)
        inbox: list[dict[int, _Message]] = [dict() for _ in range(n)]
        for k_key, slot in d.get("inbox", {}).items():
            for j_key, msg in slot.items():
                inbox[int(k_key)][int(j_key)] = _Message(
                    version=int(msg["v"]),
                    payload=pool[int(msg["pid"])])
        flags = np.asarray(d["flags"], dtype=bool)
        snap = {k: np.asarray(v, np.float64)
                for k, v in d.get("prev_snap", {}).items()}
        return _AsyncState(
            q=q, inbox=inbox,
            t_local=np.asarray(d["t_local"], np.int64).copy(),
            down_count=np.asarray(d["down_count"], np.int64).copy(),
            down_streak=np.asarray(d["down_streak"], np.int64).copy(),
            waiting=set(np.flatnonzero(flags[0]).tolist()),
            done=set(np.flatnonzero(flags[1]).tolist()),
            dead=set(np.flatnonzero(flags[2]).tolist()),
            emitted=int(d["emitted"]),
            last_finish=float(d["last_finish"]),
            prev_snap=snap or None)

    # ------------------------------------------------------------------
    # sync mode: RoundEngine semantics + a virtual timeline
    # ------------------------------------------------------------------
    def _pre_round(self, ctx: RoundCtx) -> None:
        # capture what the mix phase transmits: the pre-mix masks' nnz on the
        # current adjacency (measured, not assumed).  Strategies that don't
        # gossip over the adjacency (server-based / local-only) move no
        # P2P bytes, so their timeline is compute-only
        if not self.strategy.decentralized:
            self._pending_edges = None
            return
        strat, state = self.strategy, self.state
        nnz = [strat.message_nnz(state, k) for k in range(len(self.clients))]
        coords = strat.message_coords(state, 0)
        self._pending_edges = (
            edge_message_bytes(ctx.adjacency, nnz),
            edge_message_bytes(ctx.adjacency, nnz, coords, with_bitmap=True))

    def _finish_metrics(self, ctx: RoundCtx, metrics: RoundMetrics) -> RoundMetrics:
        edges = self._pending_edges
        self._pending_edges = None
        t0 = self.clock.now
        n = len(self.clients)
        compute_s = np.array([
            self.compute.local_time(k, metrics.flops_round)
            for k in range(n)])
        dur = float(compute_s.max()) if n else 0.0
        tr = get_tracer()
        if tr.enabled:
            for k in range(n):
                tr.add_span("compute", t0, t0 + float(compute_s[k]),
                            track=f"client/{k}", clock=VIRTUAL, round=ctx.t)
        if edges is not None:
            edges_v, edges_w = edges
            for src in range(n):
                dsts = np.flatnonzero(edges_v[:, src])
                if dsts.size == 0:
                    continue
                jobs = [(int(d), float(edges_v[d, src]),
                         float(edges_w[d, src])) for d in dsts]
                # the barrier waits for every model to arrive — the round
                # ends at the last arrival (retransmits included; sync
                # transport is reliable, so state matches RoundEngine)
                for _dst, _ok, end in self._transmit(
                        src, jobs, t0 + compute_s[src], ctx.t, reliable=True):
                    dur = max(dur, end - t0)
        self.clock.advance_to(t0 + dur)
        if metrics.acc_mean is not None:
            self.acc_trace.append((self.clock.now, metrics.acc_mean))
        self._sample_sim_series()
        up, down = self.stats.up * MB, self.stats.down * MB
        return SimRoundMetrics(
            **dataclasses.asdict(metrics),
            sim_time_s=self.clock.now, sim_round_s=dur,
            measured_total_mb=self.stats.total_mb,
            busiest_up_mb=float(up.max()), busiest_down_mb=float(down.max()),
            min_round=ctx.t + 1, max_round=ctx.t + 1,
            retrans_mb=self.stats.retrans_mb,
            lost_messages=self.stats.n_lost)

    # ------------------------------------------------------------------
    # async mode
    # ------------------------------------------------------------------
    def rounds(self):
        if self.mode == "sync":
            yield from super().rounds()
            return
        yield from self._async_rounds()

    def _mix_one(self, k: int, senders: dict[int, _Message], ctx: RoundCtx) -> None:
        """Mix client k against arrived payloads via ``Strategy.mix_one``.

        Decentralized strategies implement it as O(degree) packed folds
        (``sparse.ops``); the ``StrategyBase`` fallback swaps the
        payloads in, runs the full ``mix`` on an adjacency whose only
        non-identity row is k's, and restores — correct for any strategy,
        but O(K) tree work per activation.
        """
        self.strategy.mix_one(
            self.state, k, {j: m.payload for j, m in senders.items()}, ctx)

    def _fresh_async_state(self) -> _AsyncState:
        n = len(self.clients)
        st = _AsyncState(
            q=EventQueue(),
            inbox=[dict() for _ in range(n)],
            t_local=np.zeros(n, dtype=np.int64),
            down_count=np.zeros(n, dtype=np.int64),
            down_streak=np.zeros(n, dtype=np.int64),
            waiting=set(), done=set(), dead=set(),
            emitted=0, last_finish=0.0,
            prev_snap=self.stats.snapshot())
        for k in range(n):
            st.q.push(0.0, WAKE, k=k)
        return st

    def _live_floor(self, st: _AsyncState) -> int:
        """Slowest *participating* client's completed rounds — dead clients
        (permanently unavailable) stop bounding progress.  With nobody left
        alive no further progress is possible, so the floor freezes at the
        rounds already emitted (the run ends partial rather than
        fabricating untrained rounds)."""
        n = len(self.clients)
        alive_t = [int(st.t_local[i]) for i in range(n) if i not in st.dead]
        return min(alive_t) if alive_t else st.emitted

    def _emit_ready_rounds(self, st: _AsyncState) -> Iterator[SimRoundMetrics]:
        """Yield one SimRoundMetrics per newly completed global round (a
        round is complete once the slowest client passes it).  All counters
        — ``emitted``, ``prev_snap``, ``_next_round``, accuracy history —
        advance *before* each yield, so a checkpoint taken from a round's
        callback captures exactly "rounds <= t complete" and a resumed run
        re-emits any rounds still pending at the cut."""
        cfg = self.cfg
        strat = self.strategy
        while st.emitted < self._live_floor(st):
            t = st.emitted
            ctx = self._make_ctx(t)
            comm_sn = self.stats.snapshot()
            prev = st.prev_snap or {k: np.zeros_like(v)
                                    for k, v in comm_sn.items()}
            win_up = comm_sn["up"] - prev["up"]
            win_down = comm_sn["down"] - prev["down"]
            win_up_w = comm_sn["up_wire"] - prev["up_wire"]
            win_down_w = comm_sn["down_wire"] - prev["down_wire"]
            st.prev_snap = comm_sn
            busiest = float(np.maximum(win_up, win_down).max()) * MB
            flops = strat.round_flops(self.state, ctx)
            self._comm["busiest_mb"].append(busiest)
            self._comm["avg_per_node_mb"].append(
                float(np.maximum(win_up, win_down).mean()) * MB)
            self._comm["total_mb"].append(float(win_up.sum()) * MB)
            self._comm["busiest_mb_with_bitmap"].append(
                float(np.maximum(win_up_w, win_down_w).max()) * MB)
            for key in self._flops:
                self._flops[key].append(float(getattr(flops, key)))
            acc_mean = acc_std = None
            if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
                accs = evaluate_clients(
                    self.task, strat.eval_params(self.state, ctx),
                    self.clients)
                acc_mean = float(np.mean(accs))
                acc_std = float(np.std(accs))
                self._acc_history.append(acc_mean)
                self._acc_stds.append(acc_std)
                self._eval_rounds.append(t)
                self.acc_trace.append((self.clock.now, acc_mean))
            up, down = self.stats.up * MB, self.stats.down * MB
            st.emitted += 1
            self._next_round = st.emitted
            self._sample_sim_series()
            metrics = SimRoundMetrics(
                round=t, lr=ctx.lr, prune_rate=ctx.prune_rate,
                comm_busiest_mb=busiest,
                comm_rows={"busiest_MB": round(busiest, 3)},
                flops_round=flops.per_round_flops,
                cum_flops=float(np.sum(self._flops["per_round_flops"])),
                acc_mean=acc_mean, acc_std=acc_std, wall_s=0.0,
                sim_time_s=self.clock.now, sim_round_s=0.0,
                measured_total_mb=self.stats.total_mb,
                busiest_up_mb=float(up.max()),
                busiest_down_mb=float(down.max()),
                min_round=int(st.t_local.min()),
                max_round=int(st.t_local.max()),
                retrans_mb=self.stats.retrans_mb,
                lost_messages=self.stats.n_lost)
            self._sample_series(metrics)
            yield metrics

    def _async_rounds(self):
        cfg = self.cfg
        strat = self.strategy
        n = len(self.clients)
        if not strat.decentralized:
            # a non-gossip mix would read live peer state instead of what
            # arrived over the simulated links — every reported number would
            # be fiction, so refuse
            raise ValueError(
                f"async simulation requires a decentralized strategy whose "
                f"mix gossips over ctx.adjacency; '{strat.name}' is not "
                f"(strategy.decentralized is False)")
        if not isinstance(self.state.get("params"), list):
            raise ValueError(
                f"async simulation requires per-client state['params'] lists "
                f"(strategy '{strat.name}' has none)")
        if self._as is None:
            if self._next_round != 0:
                raise ValueError(
                    "this engine was restored from a non-async checkpoint "
                    "or advanced outside the event loop; async resume needs "
                    "a SimEngine mode='async' checkpoint")
            self._as = self._fresh_async_state()
        st = self._as
        self._stop = False

        # extend-on-resume: a *finished* run restored with a larger
        # cfg.rounds re-arms its retired clients instead of silently ending
        # — each gets a fresh WAKE at the restored virtual clock (dead
        # clients stay dead; mid-run resume is untouched because a client
        # only retires once t_local reaches the old cfg.rounds)
        revived = sorted(k for k in st.done
                         if k not in st.dead
                         and int(st.t_local[k]) < cfg.rounds)
        for k in revived:
            st.done.discard(k)
            st.q.push(self.clock.now, WAKE, k=k)

        def flops_at(t: int) -> float:
            ctx = self._make_ctx(int(t))
            return strat.round_flops(self.state, ctx).per_round_flops

        # rounds already completed by the cut but not yet emitted at the
        # checkpoint (a DONE may complete several global rounds at once):
        # flush them first so the resumed stream is gapless
        for m in self._emit_ready_rounds(st):
            for cb in self.callbacks:
                cb.on_round_end(self, m)
            yield m
            if self._stop:
                break

        while st.q and len(st.done) < n and not self._stop:
            ev = st.q.pop()
            self.clock.advance_to(ev.time)
            if ev.kind == ARRIVAL:
                k, src = ev.data["k"], ev.data["src"]
                msg = ev.data["msg"]
                cur = st.inbox[k].get(src)
                if cur is None or msg.version >= cur.version:
                    st.inbox[k][src] = msg
                if k in st.waiting:
                    st.waiting.discard(k)
                    self._end_waits([k], ev.time)
                    st.q.push(ev.time, WAKE, k=k)
                continue

            if ev.kind == DONE:
                # a client's round completes at its compute-finish time: only
                # now does its local clock advance, unblocking SSP waiters
                # and (possibly) completing a global round
                k = ev.data["k"]
                st.t_local[k] += 1
                st.last_finish = max(st.last_finish, ev.time)
                if st.t_local[k] >= cfg.rounds:
                    st.done.add(k)
                else:
                    st.q.push(ev.time, WAKE, k=k)
                if self._live_floor(st) > st.emitted:
                    waiters = sorted(st.waiting)
                    for w in waiters:
                        st.q.push(ev.time, WAKE, k=w)
                    st.waiting.clear()
                    self._end_waits(waiters, ev.time)
                    for m in self._emit_ready_rounds(st):
                        for cb in self.callbacks:
                            cb.on_round_end(self, m)
                        yield m
                        if self._stop:
                            break
                continue

            k = ev.data["k"]
            if k in st.done:
                continue
            t_k = int(st.t_local[k])
            # bounded staleness (SSP): never run more than `staleness` rounds
            # ahead of the slowest participating client
            spread = t_k - self._live_floor(st)
            if self.staleness >= 0 and spread > self.staleness:
                st.waiting.add(k)
                self._wait_since.setdefault(k, ev.time)
                continue
            # availability: a down client retries one mean-round later
            # against its next slot; after max_down_retries consecutive down
            # slots it is declared dead so it cannot stall the whole network
            if not self.availability.up(k, t_k + int(st.down_count[k])):
                st.down_count[k] += 1
                st.down_streak[k] += 1
                if st.down_streak[k] > self.max_down_retries:
                    st.dead.add(k)
                    st.done.add(k)
                    waiters = sorted(st.waiting)
                    for w in waiters:
                        st.q.push(ev.time, WAKE, k=w)
                    st.waiting.clear()
                    self._end_waits(waiters, ev.time)
                    for m in self._emit_ready_rounds(st):
                        for cb in self.callbacks:
                            cb.on_round_end(self, m)
                        yield m
                        if self._stop:
                            break
                    continue
                retry = self.compute.mean_round_s(flops_at(t_k))
                st.q.push(ev.time + max(retry, 1e-9), WAKE, k=k)
                continue
            st.down_streak[k] = 0
            self.observed_spread = max(self.observed_spread, max(0, spread))

            # 1. mix what has arrived (respecting the staleness bound)
            senders = {
                j: m for j, m in st.inbox[k].items()
                if self.staleness < 0 or t_k - m.version <= self.staleness}
            for m in senders.values():
                self.observed_mix_lag = max(self.observed_mix_lag,
                                            max(0, t_k - m.version))
            self.mixed_messages += len(senders)
            a = np.eye(n)
            if senders:
                a[k, list(senders)] = 1.0
            ctx = RoundCtx(
                t=t_k, cfg=cfg, task=self.task, clients=self.clients,
                lr=cfg.lr_at(t_k),
                prune_rate=cosine_prune_rate(cfg.alpha0, t_k, cfg.rounds),
                adjacency=a)
            self._mix_one(k, senders, ctx)

            # 2. local phase + mask evolution (same hooks, same derived rng)
            self.run_local_phase(ctx, [k])
            strat.evolve(self.state, k, ctx)

            # 3. compute time, then push to sampled receivers.  The payload
            # is the packed message itself; its sizes are codec-measured
            # from what actually ships, not recomputed from nnz.  Sends
            # queue on the sender's shared uplink (unless uplink="parallel")
            # and may be dropped + retransmitted by the loss model; a
            # message that exhausts its budget never ARRIVEs
            flops = strat.round_flops(self.state, ctx).per_round_flops
            finish = ev.time + self.compute.local_time(k, flops)
            tr = get_tracer()
            if tr.enabled:
                tr.add_span("compute", ev.time, finish, track=f"client/{k}",
                            clock=VIRTUAL, round=t_k)
            payload = strat.snapshot_message(self.state, k)
            bytes_v, bytes_w = measure_payload(payload)
            msg = _Message(version=t_k + 1, payload=payload)
            receivers = directed_out_neighbors(n, k, t_k, cfg.degree, cfg.seed)
            jobs = [(int(j), bytes_v, float(bytes_w)) for j in receivers]
            for j, delivered, arrive in self._transmit(
                    k, jobs, finish, t_k + 1, reliable=False):
                if delivered:
                    st.q.push(arrive, ARRIVAL, k=j, src=k, msg=msg)

            # 4. the round completes (and the local clock advances) at the
            # compute-finish time, handled by the DONE event above
            st.q.push(finish, DONE, k=k)
        # the run ends when the last client finishes its compute, even if
        # some already-sent messages are still in flight
        self.clock.advance_to(max(st.last_finish, self.clock.now))
        self._end_waits(list(self._wait_since), self.clock.now)
        for m in self._emit_ready_rounds(st):
            for cb in self.callbacks:
                cb.on_round_end(self, m)
            yield m
        for cb in self.callbacks:
            cb.on_run_end(self)
