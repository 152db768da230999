"""Deterministic request stream + cache-aware micro-batcher (reference
``repro.serve.batcher``, copied line for line: the same stream gives the
same requests, batches, flush times and waits in both packages).

Serving experiments must be reproducible: two runs with the same seed and
knobs must form the *same* batches, touch the cache in the same order and
report the same hit/miss/eviction counts.  So arrivals are synthetic and
fully seed-derived (``np.random.SeedSequence([seed, ...])`` streams, the
same discipline as the round engine's per-``(seed, round, client)`` rng):
user ids from a Zipf-tilted popularity (hot users exist, which is what
makes an LRU cache worth having), exponential inter-arrival gaps at
``rate`` requests per virtual second, and a per-request input seed the
model adapter turns into the request payload.

``MicroBatcher`` groups pending requests into one device launch each.  Two
knobs bound the grouping:

* ``max_batch`` — at most this many requests per launch;
* ``max_wait`` — a pending request is never held longer than this many
  *virtual* seconds past its arrival before a flush.

A flush takes at most one request per user: a launch scores each user's
pool slot once, so a second same-user request in the window stays pending
for the next flush (its ``max_wait`` deadline still holds — the overdue
check runs before every arrival).  Within a flush, requests whose user
models are already resident in the unpack cache go first (``resident``
predicate — grouping by resident models keeps the launch from paying
unpack misses for users it could have deferred); ties keep arrival order,
so the whole schedule is a pure function of (stream, knobs, cache state)
and therefore of the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int                 # arrival index (0-based, dense)
    user: int                # which personalized model serves it
    t_arrival: float         # virtual seconds since stream start
    input_seed: int          # per-request payload seed (model adapter rng)


class RequestStream:
    """Seed-derived arrivals over ``n_users`` personalized models."""

    def __init__(self, n_users: int, n_requests: int, seed: int = 0,
                 rate: float = 1000.0, zipf_a: float = 1.1,
                 popularity: str = "zipf"):
        if popularity not in ("zipf", "uniform"):
            raise ValueError(f"popularity must be zipf|uniform, got {popularity}")
        self.n_users = int(n_users)
        self.n_requests = int(n_requests)
        self.seed = int(seed)
        self.rate = float(rate)
        self.zipf_a = float(zipf_a)
        self.popularity = popularity

    def requests(self) -> list[Request]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0xA11]))
        if self.popularity == "zipf":
            # Zipf-tilted popularity over a seed-shuffled user order, so
            # "hot" users are not always the low ids
            ranks = np.arange(1, self.n_users + 1, dtype=np.float64)
            probs = ranks ** (-self.zipf_a)
            probs /= probs.sum()
            order = rng.permutation(self.n_users)
            users = order[rng.choice(self.n_users, size=self.n_requests,
                                     p=probs)]
        else:
            users = rng.integers(0, self.n_users, size=self.n_requests)
        gaps = rng.exponential(1.0 / self.rate, size=self.n_requests)
        times = np.cumsum(gaps)
        seeds = rng.integers(0, 2**31 - 1, size=self.n_requests)
        return [Request(rid=i, user=int(users[i]), t_arrival=float(times[i]),
                        input_seed=int(seeds[i]))
                for i in range(self.n_requests)]

    def __iter__(self) -> Iterator[Request]:
        return iter(self.requests())


@dataclasses.dataclass(frozen=True)
class Batch:
    t_flush: float                  # virtual time the flush decision fired
    requests: tuple[Request, ...]   # launch order: resident users first

    @property
    def users(self) -> tuple[int, ...]:
        return tuple(r.user for r in self.requests)

    def queue_waits(self) -> list[float]:
        """Virtual seconds each request spent pending before its launch."""
        return [self.t_flush - r.t_arrival for r in self.requests]


class MicroBatcher:
    """Greedy deterministic micro-batching over an arrival sequence.

    ``resident`` is the cache predicate (``ModelStore.resident``); pass
    None to disable cache-aware ordering (pure arrival order).
    """

    def __init__(self, requests: Sequence[Request] | RequestStream,
                 max_batch: int = 8, max_wait: float = 0.005,
                 resident: Optional[Callable[[int], bool]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.requests = list(requests)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.resident = resident

    def _flush(self, pending: list[Request], t_flush: float) -> Batch:
        # one request per user per launch (a pool slot serves one model);
        # same-user duplicates keep their place in line for the next flush
        take: list[Request] = []
        seen: set[int] = set()
        rest: list[Request] = []
        for r in pending:
            if len(take) < self.max_batch and r.user not in seen:
                take.append(r)
                seen.add(r.user)
            else:
                rest.append(r)
        pending[:] = rest
        if self.resident is not None:
            # stable partition: resident-model requests first, arrival
            # order preserved inside each group
            take = ([r for r in take if self.resident(r.user)]
                    + [r for r in take if not self.resident(r.user)])
        return Batch(t_flush=t_flush, requests=tuple(take))

    def batches(self) -> Iterator[Batch]:
        pending: list[Request] = []
        for req in self.requests:
            # a pending request's max_wait deadline may expire before this
            # arrival: flush the overdue prefix first, at its deadline
            while pending and req.t_arrival > pending[0].t_arrival + self.max_wait:
                yield self._flush(pending, pending[0].t_arrival + self.max_wait)
            pending.append(req)
            if len(pending) >= self.max_batch:
                yield self._flush(pending, req.t_arrival)
        while pending:
            yield self._flush(pending, pending[0].t_arrival + self.max_wait)
