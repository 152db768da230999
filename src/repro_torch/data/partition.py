"""Non-IID partitioners (paper §4.1 / App. B.1).

* ``dirichlet_partition`` — per class, split its sample indices across the K
  clients with proportions ~ Dir(alpha) (Hsu et al. 2019).  alpha=0.3 for
  CIFAR-10-like, 0.2 for CIFAR-100-like tasks in the paper.
* ``pathological_partition`` — each client holds ``classes_per_client``
  random classes (2 for CIFAR-10, 10 for CIFAR-100, 20 for Tiny-ImageNet).
* ``matched_test_indices`` — per-client test sets with the *same label
  proportions* as the client's training split (the paper's personalized
  evaluation protocol; total test size fixed per client).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for k, part in enumerate(np.split(idx, cuts)):
                idx_per_client[k].extend(part.tolist())
        sizes = [len(v) for v in idx_per_client]
        if min(sizes) >= min_size:
            break
    return [np.array(sorted(v)) for v in idx_per_client]


def pathological_partition(labels: np.ndarray, n_clients: int,
                           classes_per_client: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    # assign classes to clients (each class appears on roughly equal #clients)
    assignments: list[list[int]] = [[] for _ in range(n_clients)]
    pool = []
    while len(pool) < n_clients * classes_per_client:
        perm = rng.permutation(n_classes).tolist()
        pool.extend(perm)
    for k in range(n_clients):
        take = []
        for c in pool:
            if len(take) == classes_per_client:
                break
            if c not in take:
                take.append(c)
        for c in take:
            pool.remove(c)
        assignments[k] = take
    # split each class's samples evenly among the clients holding it
    holders: dict[int, list[int]] = {c: [] for c in range(n_classes)}
    for k, cs in enumerate(assignments):
        for c in cs:
            holders[c].append(k)
    idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        ks = holders[c]
        if not ks:
            continue
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        for k, part in zip(ks, np.array_split(idx, len(ks))):
            idx_per_client[k].extend(part.tolist())
    return [np.array(sorted(v)) for v in idx_per_client]


def label_distribution(labels: np.ndarray, idx: np.ndarray, n_classes: int) -> np.ndarray:
    counts = np.bincount(labels[idx], minlength=n_classes).astype(np.float64)
    return counts / max(counts.sum(), 1)


def matched_test_indices(test_labels: np.ndarray, train_dist: np.ndarray,
                         n_test: int, seed: int = 0) -> np.ndarray:
    """Sample a per-client test set matching the client's label distribution."""
    rng = np.random.default_rng(seed)
    n_classes = len(train_dist)
    counts = np.floor(train_dist * n_test).astype(int)
    # distribute the remainder to the largest-proportion classes
    rem = n_test - counts.sum()
    order = np.argsort(-train_dist)
    for i in range(rem):
        counts[order[i % n_classes]] += 1
    out = []
    for c in range(n_classes):
        if counts[c] == 0:
            continue
        pool = np.where(test_labels == c)[0]
        take = rng.choice(pool, size=counts[c], replace=len(pool) < counts[c])
        out.extend(take.tolist())
    return np.array(sorted(out))
