"""Client up/down schedules — ONE failure model for engine and simulator
(reference ``repro.sim.availability``, copied line for line).

The Bernoulli draws live in ``core.topology.bernoulli_alive`` and are
keyed by (seed, slot): the round engine's ``cfg.drop_prob`` path, the fig-6
dropping benchmark and the event simulator all read the *same* alive sets
for the same (seed, slot) pairs, so "the dropping experiment" means one
thing everywhere.

Slots are communication rounds in the synchronous engine; the asynchronous
engine advances a client's slot on every activation attempt (a down client
retries one mean-round later against its next slot).

Availability models are *stateless*: ``alive(slot)`` is a pure function of
(seed, slot), so nothing here needs checkpointing — the simulator's slot
counters (``down_count`` per client) live in ``SimEngine``'s event-loop
state and are serialized by ``SimEngine.save``, which is what makes a
resumed fault-injection run replay the exact same up/down schedule.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import apply_availability, bernoulli_alive

__all__ = [
    "Availability", "AlwaysUp", "BernoulliAvailability", "TraceAvailability",
    "apply_availability", "bernoulli_alive", "dropping_trace",
]


class Availability:
    """Base: every client is always up."""

    def __init__(self, n_clients: int):
        self.n_clients = n_clients

    def alive(self, slot: int) -> np.ndarray:
        return np.ones(self.n_clients, dtype=bool)

    def up(self, k: int, slot: int) -> bool:
        return bool(self.alive(slot)[k])

    @property
    def always_up(self) -> bool:
        return type(self) is Availability or isinstance(self, AlwaysUp)


class AlwaysUp(Availability):
    pass


class BernoulliAvailability(Availability):
    """i.i.d. per-slot drops — bit-identical to ``cfg.drop_prob`` in the
    round engine (both call ``topology.bernoulli_alive``)."""

    def __init__(self, n_clients: int, drop_prob: float, seed: int = 0):
        super().__init__(n_clients)
        self.drop_prob = float(drop_prob)
        self.seed = int(seed)

    def alive(self, slot: int) -> np.ndarray:
        return bernoulli_alive(self.n_clients, slot, self.drop_prob, self.seed)


class TraceAvailability(Availability):
    """Explicit (slots, clients) boolean trace, cycled when the run is
    longer than the trace (for replaying measured availability logs)."""

    def __init__(self, trace: np.ndarray):
        trace = np.asarray(trace, dtype=bool)
        if trace.ndim != 2 or trace.shape[0] == 0:
            raise ValueError("trace must be a non-empty (slots, clients) array")
        super().__init__(trace.shape[1])
        self.trace = trace

    def alive(self, slot: int) -> np.ndarray:
        return self.trace[slot % len(self.trace)]

    @classmethod
    def from_bernoulli(cls, n_clients: int, slots: int, drop_prob: float,
                       seed: int = 0) -> "TraceAvailability":
        """Materialize the Bernoulli model into an explicit trace (identical
        draws — useful for inspecting or editing a dropping scenario)."""
        return cls(np.stack([
            bernoulli_alive(n_clients, s, drop_prob, seed)
            for s in range(slots)]))


def dropping_trace(n_clients: int, rounds: int, drop_prob: float,
                   seed: int = 0) -> TraceAvailability:
    """The fig-6 (App. B.6) client-dropping scenario as an explicit trace."""
    return TraceAvailability.from_bernoulli(n_clients, rounds, drop_prob, seed)
