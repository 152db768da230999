"""Packed compute: decode / gossip / axpy over ``PackedSparse`` payloads
(reference ``repro.sparse.ops``).

A client keeps one pair of dense accumulators (num, den) per leaf and folds
each payload in as ``num += alpha * scatter(values)``, ``den += bitmap``,
then finalizes with the intersection average, so ``packed_gossip_one`` is
bit-identical to ``core.gossip.gossip_average_one`` fed the equivalent dense
neighbours.  The fold is ``kernels.packed_accum`` — the CUDA kernel for CUDA
tensors (the reference's ``"pallas"`` backend), its plain version on the CPU
(the reference's ``"ref"`` backend); the device of the tensors decides.

Folds update the accumulators in place; every function here allocates the
accumulators it folds into, so callers' tensors are never modified.

``COUNTERS`` counts the folds the reference's ``accumulate`` and
``packed_axpy`` count (mirrored into the ``sparse.ops`` counter set);
``decode_tree``, which stands where the reference's barrier mix calls
``unpack_tree``, counts as a tree unpack instead, so a run's counters equal
the reference's.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core.gossip import _intersection_avg
from repro_torch.kernels.packed_accum import packed_accum
from repro_torch.obs import CounterSet, span
from repro_torch.sparse import packed as _packed
from repro_torch.sparse.packed import PackedSparse, is_packed
from repro_torch.utils.tree import tree_map, tree_unzip

PyTree = Any

#: accumulate instrumentation: calls == payload-leaf folds performed,
#: values == nnz actually touched (reset with ``reset_counters``)
COUNTERS = {"accum_calls": 0, "accum_values": 0}

# mirror the dict into the process-wide registry (the gauges read it live)
OBS = CounterSet("sparse.ops")
OBS.gauge("accum_calls", fn=lambda: COUNTERS["accum_calls"])
OBS.gauge("accum_values", fn=lambda: COUNTERS["accum_values"])


def reset_counters() -> None:
    COUNTERS["accum_calls"] = 0
    COUNTERS["accum_values"] = 0


def accumulate(num: torch.Tensor, den: torch.Tensor, ps: PackedSparse,
               alpha: float = 1.0):
    """Fold one packed leaf into dense (num, den) accumulators, in place."""
    COUNTERS["accum_calls"] += 1
    COUNTERS["accum_values"] += ps.nnz
    packed_accum(num.view(-1), den.view(-1), ps.bitmap, ps.values, alpha)
    return num, den


def decode(ps: PackedSparse):
    """(w ⊙ m, m) of one payload in float32, by folding it into zero
    accumulators (not counted in ``COUNTERS``)."""
    num = torch.zeros(ps.shape, dtype=torch.float32, device=ps.values.device)
    den = torch.zeros(ps.shape, dtype=torch.float32, device=ps.values.device)
    packed_accum(num.view(-1), den.view(-1), ps.bitmap, ps.values, 1.0)
    return num, den


def decode_tree(packed: PyTree):
    """(params, masks) trees of one packed tree, each payload decoded once
    — one tree unpack (``sparse.packed/tree_unpacks``, a
    ``codec.unpack_tree`` span)."""
    with span("codec.unpack_tree", track="codec"):
        _packed.OBS.counter("tree_unpacks").inc()
        return tree_unzip(tree_map(decode, packed, is_leaf=is_packed))


def packed_gossip_one(own_params: PyTree, own_mask: PyTree,
                      neighbor_packed: Sequence[PyTree]) -> PyTree:
    """Intersection-weighted gossip for ONE client from packed neighbour
    payloads (paper Alg. 1 line 7) — O(degree · nnz) folds, bit-identical
    to ``gossip_average_one`` on the densified neighbours."""

    def one(w, m, *packs):
        mf = m.to(w.dtype)
        num = w * mf
        den = mf.clone()
        for p in packs:
            accumulate(num, den, p, 1.0)
        return _intersection_avg(num, den, mf)

    return tree_map(one, own_params, own_mask, *neighbor_packed,
                    is_leaf=is_packed)


def packed_axpy(acc: PyTree, packed: PyTree, alpha: float) -> PyTree:
    """acc + alpha * densify(packed), leafwise, without materializing the
    densified payload outside the fused fold."""

    def one(a, p):
        num, _ = accumulate(a.clone(), torch.zeros_like(a), p, alpha)
        return num

    return tree_map(one, acc, packed, is_leaf=is_packed)
