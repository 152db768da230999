"""Per-edge link models, fault models, and measured bytes-on-wire
(reference ``repro.sim.links``, copied line for line but for how
``measure_payload`` walks a packed tree).

``LinkModel`` maps a message size to a transfer time per directed edge
(latency + bytes / bandwidth), optionally modulated by a time-varying
``BandwidthTrace``.  ``UplinkScheduler`` serializes a sender's concurrent
transfers on its shared uplink (FIFO or processor-sharing fair-share)
instead of letting every edge run in parallel — which is what changes
busiest-node timelines, the paper's key metric.  ``LossModel`` drops
messages per-link with a derived-rng Bernoulli draw and schedules
timeout/retransmit attempts; every attempt's bytes are counted on the wire.

``LinkStats`` records every transfer the simulator actually performs —
sender, receiver, and the payload's size *measured from what is actually
shipped*: messages are ``sparse.packed`` trees and ``measure_payload``
sizes them with the wire codec (``codec.encoded_nbytes``, bitmap and frame
header included), so busiest-node traffic and per-link utilization are
measured quantities, not analytic assumptions.  The codec frame is an exact
function of (nnz, coords, itemsize), which keeps measured totals
bit-commensurable with ``core.accounting.decentralized_comm``.

Everything stateful here (``UplinkScheduler.free_at``, the ``LinkStats``
accumulators and transfer log) exposes ``state_dict``/``load_state`` so
``SimEngine.save``/``restore`` can round-trip a mid-run simulation
bit-identically; the ``LossModel`` itself is stateless — every drop draw is
a pure function of (seed, src, dst, message tag, attempt).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.accounting import message_bytes
from repro_torch.obs import CounterSet, SeriesSet
from repro_torch.sparse import codec
from repro_torch.sparse.packed import is_packed
from repro_torch.utils.tree import tree_leaves, tree_nnz, tree_size

MB = 1e-6  # decimal MB, matching the paper's tables

# SeedSequence sub-stream tag for per-(src, dst, message, attempt) drop
# draws — disjoint from the engine's training streams and the topology's
# AVAIL/GOSSIP streams so loss never perturbs training randomness.
LOSS_STREAM = 65537

UPLINK_MODES = ("parallel", "fifo", "fair")


def measure_payload(payload: dict) -> tuple[float, int]:
    """(value bytes, wire bytes) of one message payload.

    Packed payloads (the default ``StrategyBase.snapshot_message``) are
    sized exactly: value bytes from the held values' own itemsize, wire
    bytes from ``codec.encoded_nbytes`` of the frame the link would carry.
    Dense ``{"params", "mask"}`` payloads fall back to the analytic
    ``accounting.message_bytes`` from the mask's nnz.
    """
    packed = payload.get("packed")
    if packed is not None:
        # metadata only (nnz * itemsize) — no device-to-host copy
        nbytes = sum(p.nnz * p.values.dtype.itemsize
                     for p in tree_leaves(packed, is_leaf=is_packed))
        return float(nbytes), codec.encoded_nbytes(packed)
    params = payload["params"]
    nnz = (tree_nnz(payload["mask"]) if payload.get("mask") is not None
           else tree_size(params))
    coords = tree_size(params)
    return (message_bytes(nnz),
            int(message_bytes(nnz, coords, with_bitmap=True)))


class BandwidthTrace:
    """Piecewise-constant time-varying bandwidth multipliers.

    ``scale_at(t, k)`` is the factor applied to every link whose *sender* is
    ``k`` at virtual time ``t``: ``times`` are ascending breakpoints,
    ``scales`` holds either one global multiplier per breakpoint (shape
    ``(T,)``) or one per client (``(T, n_clients)``); the last value holds
    forever (step function, no interpolation).  A transfer is priced at the
    bandwidth in force when it *starts* — rates do not change mid-transfer,
    which keeps every (start, end) pair an exact closed form.
    """

    def __init__(self, times: Sequence[float], scales: np.ndarray):
        self.times = np.asarray(times, dtype=float)
        self.scales = np.asarray(scales, dtype=float)
        if self.times.ndim != 1 or self.times.size == 0:
            raise ValueError("trace times must be a non-empty 1-D sequence")
        if np.any(np.diff(self.times) < 0):
            raise ValueError("trace times must be ascending")
        if self.scales.shape[0] != self.times.size:
            raise ValueError("one scale row per breakpoint required")
        if np.any(self.scales <= 0):
            raise ValueError("bandwidth scales must be positive")

    def scale_at(self, t: float, k: int) -> float:
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        i = max(i, 0)
        row = self.scales[i]
        return float(row if row.ndim == 0 else row[k])

    @classmethod
    def from_json(cls, path: str) -> "BandwidthTrace":
        """Load ``{"times": [...], "scale": [...]}`` (scale entries either
        scalars or per-client lists) — the ``--bandwidth-trace`` file."""
        with open(path) as f:
            d = json.load(f)
        return cls(d["times"], np.asarray(d["scale"], dtype=float))


class LinkModel:
    """Directed per-edge bandwidth/latency: time = latency + bytes * 8 / bw.

    ``trace`` (a ``BandwidthTrace``) scales the sender's outgoing bandwidth
    as a function of virtual time — trace-driven link schedules.
    """

    def __init__(self, bandwidth_mbps: np.ndarray | float,
                 latency_s: np.ndarray | float = 0.01, n_clients: int = 0,
                 trace: Optional[BandwidthTrace] = None):
        if np.isscalar(bandwidth_mbps):
            bandwidth_mbps = np.full((n_clients, n_clients), float(bandwidth_mbps))
        if np.isscalar(latency_s):
            latency_s = np.full_like(np.asarray(bandwidth_mbps, float),
                                     float(latency_s))
        self.bw_mbps = np.asarray(bandwidth_mbps, dtype=float)
        self.latency_s = np.asarray(latency_s, dtype=float)
        self.trace = trace
        if np.any(self.bw_mbps <= 0):
            raise ValueError("bandwidth must be positive")

    @classmethod
    def uniform(cls, n_clients: int, mbps: float = 100.0,
                latency_ms: float = 10.0,
                trace: Optional[BandwidthTrace] = None) -> "LinkModel":
        return cls(mbps, latency_ms / 1e3, n_clients, trace=trace)

    @classmethod
    def skewed(cls, n_clients: int, mbps: float = 100.0, skew: float = 10.0,
               slow_frac: float = 0.5, latency_ms: float = 10.0,
               seed: int = 0,
               trace: Optional[BandwidthTrace] = None) -> "LinkModel":
        """A ``slow_frac`` subset of clients sits behind ``skew``x slower
        links (any edge touching a slow client): the bandwidth-heterogeneity
        regime where async gossip should beat the synchronous barrier."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, 314159]))
        slow = rng.permutation(n_clients) < int(round(slow_frac * n_clients))
        bw = np.full((n_clients, n_clients), mbps)
        bw[slow, :] = mbps / skew
        bw[:, slow] = mbps / skew
        return cls(bw, latency_ms / 1e3, trace=trace)

    def serialization_time(self, n_bytes: float, src: int, dst: int,
                           t: float = 0.0) -> float:
        """Seconds the *uplink* is occupied putting the frame on the wire
        (excludes propagation latency) at the bandwidth in force at ``t``."""
        bw = self.bw_mbps[src, dst]
        if self.trace is not None:
            bw *= self.trace.scale_at(t, src)
        return float(n_bytes * 8.0 / (bw * 1e6))

    def transfer_time(self, n_bytes: float, src: int, dst: int,
                      t: float = 0.0) -> float:
        return (self.serialization_time(n_bytes, src, dst, t)
                + float(self.latency_s[src, dst]))


class UplinkScheduler:
    """Serializes a sender's transfers on its shared uplink.

    Modes (the uplink discipline):

    * ``parallel`` — v1 behaviour: every edge transfers independently; a
      sender pushing to ``degree`` receivers occupies ``degree`` full-rate
      uplinks at once (physically optimistic — kept as the idealized
      baseline).
    * ``fifo`` — transfers serialize in scheduling order: each job starts
      when the uplink frees, occupies it for its serialization time, and
      arrives one propagation latency later.
    * ``fair`` — a batch of jobs submitted together shares the uplink
      processor-sharing style: with serialization times ``s_1 <= ... <= s_n``
      (full rate), job i completes at ``f_i = f_{i-1} + (s_i - s_{i-1}) *
      (n - i + 1)`` after the batch start (everyone finishes no earlier than
      under FIFO; equal-size jobs all finish together at ``n * s``).
      Batches queue FIFO behind whatever the uplink is still serving.

    ``free_at[src]`` (the busy-until bookkeeping) is the only state; jobs
    are served in *scheduling* order — a retransmit scheduled eagerly for a
    future timeout occupies its slot when the simulator reaches it, which
    keeps the whole schedule a pure deterministic function of the run.
    """

    def __init__(self, n_clients: int, mode: str = "parallel"):
        if mode not in UPLINK_MODES:
            raise ValueError(f"uplink mode must be one of {UPLINK_MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self.free_at = np.zeros(n_clients)

    def schedule(self, links: LinkModel, src: int,
                 jobs: Sequence[tuple[int, float]],
                 t_request: float) -> list[tuple[float, float]]:
        """Place ``jobs`` = [(dst, n_bytes), ...] on ``src``'s uplink from
        ``t_request``; returns one (t_start, t_arrival) pair per job."""
        if not jobs:
            return []
        if self.mode == "parallel":
            return [(t_request,
                     t_request + links.transfer_time(nb, src, dst, t_request))
                    for dst, nb in jobs]
        t0 = max(t_request, float(self.free_at[src]))
        out: list[tuple[float, float]] = []
        if self.mode == "fifo":
            t = t0
            for dst, nb in jobs:
                s = links.serialization_time(nb, src, dst, t)
                out.append((t, t + s + float(links.latency_s[src, dst])))
                t += s
            self.free_at[src] = t
            return out
        # fair: exact processor sharing of the batch from t0
        ser = [links.serialization_time(nb, src, dst, t0) for dst, nb in jobs]
        order = np.argsort(ser, kind="stable")
        finish = np.zeros(len(jobs))
        f_prev, s_prev = 0.0, 0.0
        for rank, i in enumerate(order):
            f_prev += (ser[i] - s_prev) * (len(jobs) - rank)
            s_prev = ser[i]
            finish[i] = f_prev
        for (dst, _nb), f in zip(jobs, finish):
            out.append((t0, t0 + f + float(links.latency_s[src, dst])))
        self.free_at[src] = t0 + float(finish.max())
        return out

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        return {"free_at": self.free_at.copy()}

    def load_state(self, d: dict) -> None:
        self.free_at = np.asarray(d["free_at"], dtype=float).copy()


class LossModel:
    """Per-link Bernoulli message loss with timeout/retransmit.

    A message is retransmitted until it survives the drop draw or
    ``max_retries`` resends are exhausted; every attempt's bytes go on the
    wire (``LinkStats`` counts them).  The sender detects a loss by silence:
    attempt ``i+1`` is scheduled ``timeout_s`` after attempt ``i`` finished
    serializing.  Draws derive from ``(seed, src, dst, tag, LOSS_STREAM)``
    where ``tag`` identifies the message (round in sync mode, the sender's
    published version in async mode), so the loss pattern is a pure function
    of the run — independent of event ordering and bit-reproducible on
    resume.
    """

    def __init__(self, loss_prob: float, timeout_s: float = 1.0,
                 max_retries: int = 10, seed: int = 0):
        if not 0.0 <= loss_prob < 1.0:
            raise ValueError("loss_prob must be in [0, 1)")
        if timeout_s <= 0:
            raise ValueError("retransmit timeout must be positive")
        self.loss_prob = float(loss_prob)
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.seed = int(seed)

    def attempts(self, src: int, dst: int, tag: int) -> tuple[int, bool]:
        """(number of transmissions, delivered?) for one message."""
        if self.loss_prob == 0.0:
            return 1, True
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, src, dst, tag, LOSS_STREAM]))
        draws = rng.random(self.max_retries + 1) >= self.loss_prob
        hit = np.flatnonzero(draws)
        if hit.size:
            return int(hit[0]) + 1, True
        return self.max_retries + 1, False


@dataclasses.dataclass
class Transfer:
    t_start: float
    t_end: float
    src: int
    dst: int
    bytes_values: float     # 4B-per-value payload (the paper's headline unit)
    bytes_wire: float       # payload + mask bitmap (what the link carries)
    attempt: int = 0        # 0 = first transmission, >0 = retransmit


class LinkStats:
    """Accumulates every simulated transfer.

    Totals use the paper's value-bytes convention (comparable to
    ``decentralized_comm``); ``*_wire`` adds the mask bitmap.  Retransmitted
    attempts count into the totals (the link really carried them) *and*
    into the ``retrans_*`` overlays, so reports can quote the loss-induced
    overhead separately.  ``transfers`` keeps the full timeline for
    per-link utilization and the busiest-node upload/download trajectories
    in ``sim.report``.
    """

    def __init__(self, n_clients: int):
        self.n = n_clients
        self.up = np.zeros(n_clients)        # value-bytes uploaded per node
        self.down = np.zeros(n_clients)
        self.up_wire = np.zeros(n_clients)
        self.down_wire = np.zeros(n_clients)
        self.retrans_up = np.zeros(n_clients)       # value-bytes, attempts > 0
        self.retrans_up_wire = np.zeros(n_clients)
        self.edge_bytes = np.zeros((n_clients, n_clients))   # [dst, src]
        self.edge_busy_s = np.zeros((n_clients, n_clients))
        self.n_retransmits = 0
        self.n_lost = 0                      # messages never delivered
        self.transfers: list[Transfer] = []
        # gauges mirror the checkpointed accumulators (single source of
        # truth stays here), so snapshot_counters() reconciles exactly with
        # the virtual-clock transfer spans in an exported trace
        self.obs = CounterSet("sim.links")
        self.obs.gauge("transfers", fn=lambda: len(self.transfers))
        self.obs.gauge("n_retransmits", fn=lambda: self.n_retransmits)
        self.obs.gauge("n_lost", fn=lambda: self.n_lost)
        self.obs.gauge("bytes_values", fn=lambda: float(self.up.sum()))
        self.obs.gauge("bytes_wire", fn=lambda: float(self.up_wire.sum()))
        # obs layer 2: bounded-memory sketches of transfer durations/sizes
        # (error-bounded quantiles without walking the transfers list);
        # the checkpointed transfers list stays the source of truth and the
        # sketches are rebuilt from it on load_state
        self._init_sketches()

    def _init_sketches(self) -> None:
        self.series = SeriesSet("sim.links")
        self._h_xfer_s = self.series.histogram("transfer_s")
        self._h_xfer_bytes = self.series.histogram("transfer_wire_bytes")
        for tr in self.transfers:
            self._h_xfer_s.add(max(0.0, tr.t_end - tr.t_start))
            self._h_xfer_bytes.add(tr.bytes_wire)

    def transfer_time_quantile(self, q: float) -> float:
        """Error-bounded (alpha=1%) transfer-duration quantile in seconds."""
        return self._h_xfer_s.quantile(q)

    def record(self, src: int, dst: int, bytes_values: float,
               bytes_wire: float, t_start: float, t_end: float,
               attempt: int = 0) -> None:
        self._h_xfer_s.add(max(0.0, t_end - t_start))
        self._h_xfer_bytes.add(bytes_wire)
        self.up[src] += bytes_values
        self.down[dst] += bytes_values
        self.up_wire[src] += bytes_wire
        self.down_wire[dst] += bytes_wire
        if attempt > 0:
            self.retrans_up[src] += bytes_values
            self.retrans_up_wire[src] += bytes_wire
            self.n_retransmits += 1
        self.edge_bytes[dst, src] += bytes_values
        self.edge_busy_s[dst, src] += max(0.0, t_end - t_start)
        self.transfers.append(Transfer(t_start, t_end, src, dst,
                                       bytes_values, bytes_wire, attempt))

    def record_lost(self, src: int, dst: int) -> None:
        """A message exhausted its retransmit budget and was never
        delivered (its attempts were still ``record``-ed)."""
        self.n_lost += 1

    # -- aggregates --------------------------------------------------------
    @property
    def total_mb(self) -> float:
        return float(self.up.sum()) * MB

    @property
    def total_wire_mb(self) -> float:
        return float(self.up_wire.sum()) * MB

    @property
    def retrans_mb(self) -> float:
        return float(self.retrans_up.sum()) * MB

    def per_node_mb(self) -> np.ndarray:
        """Paper convention: each node's traffic is its busiest direction."""
        return np.maximum(self.up, self.down) * MB

    def busiest_node(self) -> tuple[int, float]:
        per = self.per_node_mb()
        k = int(np.argmax(per))
        return k, float(per[k])

    def snapshot(self) -> dict:
        return {"up": self.up.copy(), "down": self.down.copy(),
                "up_wire": self.up_wire.copy(),
                "down_wire": self.down_wire.copy()}

    def busiest_mb_until(self, t: float) -> float:
        """Busiest node's value-MB counting only transfers finished by t."""
        up = np.zeros(self.n)
        down = np.zeros(self.n)
        for tr in self.transfers:
            if tr.t_end <= t:
                up[tr.src] += tr.bytes_values
                down[tr.dst] += tr.bytes_values
        return float(np.maximum(up, down).max()) * MB

    def node_timeline(self, k: int) -> list[tuple[float, float, float]]:
        """(t, cumulative up MB, cumulative down MB) at each transfer end
        involving node k — the busiest-node upload/download timeline."""
        out, up, down = [], 0.0, 0.0
        for tr in sorted(self.transfers, key=lambda r: (r.t_end, r.src, r.dst)):
            if tr.src != k and tr.dst != k:
                continue
            if tr.src == k:
                up += tr.bytes_values
            if tr.dst == k:
                down += tr.bytes_values
            out.append((tr.t_end, up * MB, down * MB))
        return out

    def utilization(self, span_s: float) -> np.ndarray:
        """Per-edge busy fraction over the run (capped at 1.0)."""
        if span_s <= 0:
            return np.zeros_like(self.edge_busy_s)
        return np.minimum(self.edge_busy_s / span_s, 1.0)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        """Flat-array form for ``checkpoint.npz`` (exact round trip)."""
        tr = np.array(
            [[t.t_start, t.t_end, t.src, t.dst,
              t.bytes_values, t.bytes_wire, t.attempt]
             for t in self.transfers], dtype=np.float64).reshape(-1, 7)
        return {
            "up": self.up.copy(), "down": self.down.copy(),
            "up_wire": self.up_wire.copy(), "down_wire": self.down_wire.copy(),
            "retrans_up": self.retrans_up.copy(),
            "retrans_up_wire": self.retrans_up_wire.copy(),
            "edge_bytes": self.edge_bytes.copy(),
            "edge_busy_s": self.edge_busy_s.copy(),
            "counters": np.asarray([self.n_retransmits, self.n_lost],
                                   dtype=np.int64),
            "transfers": tr,
        }

    def load_state(self, d: dict) -> None:
        for name in ("up", "down", "up_wire", "down_wire",
                     "retrans_up", "retrans_up_wire",
                     "edge_bytes", "edge_busy_s"):
            setattr(self, name, np.asarray(d[name], dtype=float).copy())
        counters = np.asarray(d["counters"], dtype=np.int64)
        self.n_retransmits, self.n_lost = int(counters[0]), int(counters[1])
        self.transfers = [
            Transfer(float(r[0]), float(r[1]), int(r[2]), int(r[3]),
                     float(r[4]), float(r[5]), int(r[6]))
            for r in np.asarray(d["transfers"], dtype=np.float64)]
        self._init_sketches()
