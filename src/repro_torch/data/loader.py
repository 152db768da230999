"""Per-client data containers + federated dataset assembly."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.partition import (
    dirichlet_partition,
    label_distribution,
    matched_test_indices,
    pathological_partition,
)
from repro_torch.data.synthetic import Dataset, make_image_classification


@dataclasses.dataclass
class ClientData:
    train_x: np.ndarray | torch.Tensor
    train_y: np.ndarray | torch.Tensor
    test_x: np.ndarray | torch.Tensor
    test_y: np.ndarray | torch.Tensor
    label_dist: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.train_y)

    def epoch_batches(self, rng: np.random.Generator, batch_size: int):
        """One shuffled epoch of (x, y) batches (last partial batch kept)."""
        order = rng.permutation(self.n_train)
        for i in range(0, self.n_train, batch_size):
            sel = order[i: i + batch_size]
            yield self.train_x[sel], self.train_y[sel]

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        sel = rng.integers(0, self.n_train, size=min(batch_size, self.n_train))
        return self.train_x[sel], self.train_y[sel]


def clients_on(clients, device) -> list[ClientData]:
    """``clients`` with their train and test sets on ``device``, copied
    there once; the label distributions stay numpy."""
    sets = ("train_x", "train_y", "test_x", "test_y")
    return [dataclasses.replace(c, **{
        f: torch.as_tensor(getattr(c, f), device=device) for f in sets})
        for c in clients]


def build_federated_image_task(
    seed: int,
    n_clients: int,
    partition: str = "dirichlet",          # 'dirichlet' | 'pathological'
    alpha: float = 0.3,
    classes_per_client: int = 2,
    n_classes: int = 10,
    n_train_per_class: int = 100,
    n_test_per_class: int = 40,
    n_test_per_client: int = 40,
    hw: int = 16,
    noise: float = 0.8,
) -> tuple[list[ClientData], Dataset]:
    """Returns (clients, full train dataset).  Test sets are matched to each
    client's training label distribution (paper App. B.1)."""
    train, test = make_image_classification(
        seed, n_classes, n_train_per_class, n_test_per_class, hw, noise=noise)
    if partition == "dirichlet":
        parts = dirichlet_partition(train.y, n_clients, alpha, seed)
    elif partition == "pathological":
        parts = pathological_partition(train.y, n_clients, classes_per_client, seed)
    else:
        raise ValueError(partition)
    clients = []
    for k, idx in enumerate(parts):
        dist = label_distribution(train.y, idx, n_classes)
        tidx = matched_test_indices(test.y, dist, n_test_per_client, seed + 17 * k)
        clients.append(ClientData(
            train_x=train.x[idx], train_y=train.y[idx],
            test_x=test.x[tidx], test_y=test.y[tidx],
            label_dist=dist))
    return clients, train
