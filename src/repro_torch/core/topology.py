"""Communication topologies for the decentralized protocol (paper Fig. 2).

Adjacency matrices are (K, K) float arrays with A[k, j] = 1 iff client k
*receives* client j's model this round.  The diagonal is always 1 (a client
always keeps itself).  The paper's main setting is the *time-varying random*
topology where each client samples `degree` random neighbors per round and
the busiest node's fan-in is bounded by the centralized server's fan-in.
"""
from __future__ import annotations

import numpy as np

# SeedSequence sub-stream tags, disjoint from the engine's rng streams so a
# draw here never perturbs training randomness.
AVAIL_STREAM = 104729   # per-round client up/down draws (shared failure model)
GOSSIP_STREAM = 7919    # per-(round, client) directed neighbor sampling


def bernoulli_alive(
    n_clients: int, round_idx: int, drop_prob: float, seed: int = 0
) -> np.ndarray:
    """Per-round i.i.d. Bernoulli up/down draws — THE client-failure model.

    Both the round engine (via ``drop_prob``) and ``repro.sim.availability``
    derive their alive sets from this one function, so the fig-6 dropping
    experiment and the event simulator see identical failures for identical
    (seed, round) pairs."""
    if drop_prob <= 0.0:
        return np.ones(n_clients, dtype=bool)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, round_idx, AVAIL_STREAM]))
    return rng.random(n_clients) >= drop_prob


def apply_availability(a: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Zero a dropped client's row and column (it neither sends nor
    receives); every client always keeps itself (diagonal stays 1)."""
    m = np.asarray(alive, dtype=float)
    out = a * m[:, None] * m[None, :]
    np.fill_diagonal(out, 1.0)
    return out


def ring(n_clients: int) -> np.ndarray:
    """Static ring: each client hears its two ring neighbors (Fig. 2b)."""
    a = np.eye(n_clients)
    for k in range(n_clients):
        a[k, (k - 1) % n_clients] = 1.0
        a[k, (k + 1) % n_clients] = 1.0
    return a


def fully_connected(n_clients: int) -> np.ndarray:
    """All-to-all (Fig. 2c)."""
    return np.ones((n_clients, n_clients))


def time_varying_random(
    n_clients: int,
    degree: int,
    round_idx: int,
    seed: int = 0,
    drop_prob: float = 0.0,
) -> np.ndarray:
    """Time-varying topology (Fig. 2d): a random ``degree``-regular directed
    graph per round, built from ``degree`` random cyclic permutations so that
    *both* in-degree and out-degree are bounded by ``degree`` — the paper's
    busiest-node constraint ("at most 10 neighbors") caps upload and download
    alike.  ``drop_prob`` models the client-dropping experiment (App. B.6):
    a dropped client neither sends nor receives this round.
    """
    if degree >= n_clients:
        a = fully_connected(n_clients)
    else:
        rng = np.random.default_rng(np.random.SeedSequence([seed, round_idx]))
        a = np.eye(n_clients)
        for _ in range(degree):
            perm = rng.permutation(n_clients)
            # rotate the permutation cycle so no client maps to itself
            targets = perm[(np.argsort(perm) + 1) % n_clients]
            a[np.arange(n_clients), targets] = 1.0
    if drop_prob > 0.0:
        a = apply_availability(
            a, bernoulli_alive(n_clients, round_idx, drop_prob, seed))
    return a


def directed_out_neighbors(
    n_clients: int,
    k: int,
    round_idx: int,
    degree: int,
    seed: int = 0,
) -> np.ndarray:
    """Receivers of client k's push-gossip message at its local round
    ``round_idx`` — the asynchronous counterpart of the time-varying
    topology.  Sampled without replacement from a per-(seed, round, client)
    derived generator, so the draw is independent of event ordering and one
    client's schedule never perturbs another's."""
    if degree >= n_clients - 1:
        return np.array([j for j in range(n_clients) if j != k])
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, round_idx, k, GOSSIP_STREAM]))
    others = np.array([j for j in range(n_clients) if j != k])
    return np.sort(rng.choice(others, size=degree, replace=False))


def max_in_degree(kind: str, n_clients: int, degree: int = 10) -> int:
    """The most in-neighbours (self excluded) any client has under
    ``make_adjacency(kind, n_clients, ..., degree)`` in any round; drops
    only remove edges.  A fixed bound for consumers that need one shape
    for every round."""
    if kind == "ring":
        return min(2, n_clients - 1)
    if kind in ("fc", "fully_connected"):
        return n_clients - 1
    if kind in ("random", "time_varying", "dynamic"):
        return min(degree, n_clients - 1)
    raise ValueError(f"unknown topology kind: {kind}")


def busiest_node_degree(a: np.ndarray) -> int:
    """Max #models any single node must *upload* (out-degree excl. self).

    The paper's busiest-node communication metric counts the heaviest
    uploader/downloader; with symmetric random sampling the upload side
    (column sums) is the binding one.
    """
    out_deg = a.sum(axis=0) - np.diag(a)
    in_deg = a.sum(axis=1) - np.diag(a)
    return int(max(out_deg.max(), in_deg.max()))


def mixing_matrix(a: np.ndarray) -> np.ndarray:
    """Row-normalized adjacency (plain gossip average, used by D-PSGD)."""
    return a / a.sum(axis=1, keepdims=True)


def make_adjacency(
    kind: str,
    n_clients: int,
    round_idx: int = 0,
    degree: int = 10,
    seed: int = 0,
    drop_prob: float = 0.0,
    alive: np.ndarray | None = None,
) -> np.ndarray:
    """Build the round's adjacency, then apply the client-failure model.

    ``alive`` (a boolean vector, e.g. from ``repro.sim.availability``)
    overrides the built-in ``drop_prob`` Bernoulli draws; with neither, the
    topology is failure-free.  Dropping now applies uniformly to every
    ``kind`` (the seed code silently ignored ``drop_prob`` for ring/fc).
    """
    if kind == "ring":
        a = ring(n_clients)
    elif kind in ("fc", "fully_connected"):
        a = fully_connected(n_clients)
    elif kind in ("random", "time_varying", "dynamic"):
        a = time_varying_random(n_clients, degree, round_idx, seed)
    else:
        raise ValueError(f"unknown topology kind: {kind}")
    if alive is None and drop_prob > 0.0:
        alive = bernoulli_alive(n_clients, round_idx, drop_prob, seed)
    if alive is not None:
        a = apply_availability(a, alive)
    return a
