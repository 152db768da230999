"""Discrete-event substrate: event queue, virtual clock, compute model
(reference ``repro.sim.events``, copied line for line).

The simulator is a classic event loop: events carry a virtual timestamp,
the queue pops them in (time, insertion) order, and the clock only moves
forward.  Ties break on insertion sequence, which makes every run fully
deterministic — there is no wall-clock or OS scheduling anywhere in the
virtual timeline.

``ComputeModel`` converts analytic per-round training FLOPs (from
``core.accounting``) into virtual seconds via per-client effective
FLOP/s, which is how heterogeneous device speeds (the paper's "varying
computation complexities") enter the timeline.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Iterable, Iterator, Optional

import numpy as np

# event kinds
WAKE = "wake"          # a client is ready to start its next local round
ARRIVAL = "arrival"    # a neighbor's model message finished its transfer
DONE = "done"          # a client's local compute for one round finished


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int                      # insertion order; deterministic tie-break
    kind: str
    data: dict = dataclasses.field(default_factory=dict)


class EventQueue:
    """Min-heap of events ordered by (time, insertion sequence)."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, **data: Any) -> Event:
        ev = Event(float(time), next(self._seq), kind, data)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    # -- checkpointing -----------------------------------------------------
    def pending(self) -> list[Event]:
        """Pending events in pop order (non-destructive) — what a
        checkpoint must persist for the tie-breaks to survive a resume."""
        return [item[2] for item in sorted(self._heap)]

    def restore(self, events: Iterable[Event]) -> None:
        """Rebuild the queue from checkpointed events, preserving each
        event's original insertion sequence so (time, seq) ordering — and
        therefore every tie-break — is bit-identical after resume."""
        self._heap = []
        max_seq = -1
        for ev in events:
            heapq.heappush(self._heap, (ev.time, ev.seq, ev))
            max_seq = max(max_seq, ev.seq)
        self._seq = itertools.count(max_seq + 1)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


class VirtualClock:
    """Monotone virtual time in seconds."""

    def __init__(self) -> None:
        self.now = 0.0

    def advance_to(self, t: float) -> None:
        if t < self.now - 1e-12:
            raise ValueError(f"clock moved backwards: {self.now} -> {t}")
        self.now = max(self.now, float(t))


def hetero_speeds(n_clients: int, levels: tuple = (0.2, 0.4, 0.6, 0.8, 1.0),
                  seed: int = 0) -> np.ndarray:
    """Capacity levels cycled over clients and shuffled by ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 271828]))
    return rng.permutation(
        np.array([levels[k % len(levels)] for k in range(n_clients)]))


class ComputeModel:
    """Per-client effective training throughput.

    ``local_time(k, flops)`` = virtual seconds client k needs for a local
    phase costing ``flops`` — ``flops / (flops_per_s * speed[k])``.  Speed
    multipliers model device heterogeneity (a 0.2x client is 5x slower than
    a 1.0x one); they are the simulator-side counterpart of the paper's
    heterogeneous-capacity experiments.
    """

    def __init__(self, flops_per_s: float = 5e12,
                 speeds: Optional[np.ndarray] = None, n_clients: int = 0):
        if speeds is None:
            speeds = np.ones(n_clients)
        self.flops_per_s = float(flops_per_s)
        self.speeds = np.asarray(speeds, dtype=float)
        if np.any(self.speeds <= 0):
            raise ValueError("compute speeds must be positive")

    @classmethod
    def uniform(cls, n_clients: int, flops_per_s: float = 5e12) -> "ComputeModel":
        return cls(flops_per_s, np.ones(n_clients))

    @classmethod
    def heterogeneous(cls, n_clients: int, flops_per_s: float = 5e12,
                      levels: tuple = (0.2, 0.4, 0.6, 0.8, 1.0),
                      seed: int = 0) -> "ComputeModel":
        """Cycle the capacity levels over clients, shuffled by ``seed`` so the
        slow clients are not always the low indices."""
        return cls(flops_per_s, hetero_speeds(n_clients, levels, seed))

    @classmethod
    def paced(cls, n_clients: int, flops_round: float, round_s: float = 1.0,
              speeds: Optional[np.ndarray] = None) -> "ComputeModel":
        """Anchor the timescale: a speed-1.0 client finishes one local round
        (costing ``flops_round`` FLOPs) in ``round_s`` virtual seconds.
        Useful with toy tasks whose absolute FLOPs would otherwise be
        ridiculously small next to realistic link latencies."""
        return cls(flops_round / round_s, speeds, n_clients)

    def local_time(self, k: int, flops: float) -> float:
        return float(flops) / (self.flops_per_s * self.speeds[k])

    def mean_round_s(self, flops: float) -> float:
        return float(np.mean([self.local_time(k, flops)
                              for k in range(len(self.speeds))]))
