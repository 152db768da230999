"""SGD with momentum + weight decay, and the masked variant DisPFL uses
(reference ``repro.optim.sgd``).

``sgd_step`` is the plain update of the dense baselines.
``masked_sgd_step`` is Alg. 1 line 12, ``w <- w - eta * m ⊙ g``, with the
mask applied to the new weights and to the momentum, so dormant coordinates
stay exactly 0 and carry no stale state.  The arithmetic follows the
reference expression by expression, in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.utils.tree import tree_map, tree_unzip

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 5e-4
    nesterov: bool = False


def init_sgd(params: PyTree, cfg: SGDConfig) -> PyTree:
    if cfg.momentum == 0.0:
        return {}
    return {"mu": tree_map(torch.zeros_like, params)}


def _momentum_update(g, mu, cfg: SGDConfig):
    if cfg.momentum == 0.0:
        return g, None
    new_mu = cfg.momentum * mu + g
    upd = g + cfg.momentum * new_mu if cfg.nesterov else new_mu
    return upd, new_mu


def sgd_step(params: PyTree, grads: PyTree, state: PyTree, cfg: SGDConfig,
             lr: Optional[float] = None):
    """w <- w - eta * (g + wd*w), with momentum when configured; returns
    (new_params, new_state)."""
    lr = cfg.lr if lr is None else lr
    if cfg.momentum == 0.0:
        return tree_map(lambda w, g: w - lr * (g + cfg.weight_decay * w),
                        params, grads), state

    def upd(w, g, mu):
        u, new_mu = _momentum_update(g + cfg.weight_decay * w, mu, cfg)
        return w - lr * u, new_mu

    new_params, new_mu = tree_unzip(tree_map(upd, params, grads, state["mu"]))
    return new_params, {"mu": new_mu}


def masked_sgd_step(params: PyTree, grads: PyTree, mask: PyTree,
                    state: PyTree, cfg: SGDConfig,
                    lr: Optional[float] = None):
    """w <- w - eta * m ⊙ (g + wd*w); momentum masked the same way."""
    lr = cfg.lr if lr is None else lr
    if cfg.momentum == 0.0:
        return tree_map(
            lambda w, g, m: (w - lr * (g + cfg.weight_decay * w) * m.to(w.dtype))
            * m.to(w.dtype),
            params, grads, mask), state

    def upd(w, g, m, mu):
        mf = m.to(w.dtype)
        u, new_mu = _momentum_update((g + cfg.weight_decay * w) * mf, mu, cfg)
        return (w - lr * u) * mf, new_mu * mf

    new_params, new_mu = tree_unzip(
        tree_map(upd, params, grads, mask, state["mu"]))
    return new_params, {"mu": new_mu}


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(torch.add, params, updates)
