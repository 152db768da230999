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
accumulators it folds into, so callers' tensors are never modified.  The
tree-level functions (``decode_tree``, ``packed_gossip_one``,
``packed_axpy``) hand all their folds to one ``packed_accum_all``: one
host read checks every leaf of every payload, and a malformed leaf is
refused before anything is folded.

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
# the module, not the name: the kernel module imports ``sparse.packed``,
# whose package imports this module
from repro_torch.kernels import packed_accum as _fold_kernel
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


def _fold(folds: list) -> None:
    """Fold every ``(num, den, payload leaf, alpha)`` in order, counted as
    the reference's ``accumulate`` counts, with one read-back for all."""
    COUNTERS["accum_calls"] += len(folds)
    COUNTERS["accum_values"] += sum(ps.nnz for _, _, ps, _ in folds)
    _fold_kernel.packed_accum_all([
        (num.view(-1), den.view(-1), ps.bitmap, ps.values, alpha)
        for num, den, ps, alpha in folds])


def accumulate(num: torch.Tensor, den: torch.Tensor, ps: PackedSparse,
               alpha: float = 1.0):
    """Fold one packed leaf into dense (num, den) accumulators, in place."""
    _fold([(num, den, ps, alpha)])
    return num, den


def decode_into(decodes) -> None:
    """Decode each ``(payload, num, den)`` of ``decodes`` into its
    contiguous float32 ``num`` and ``den`` of the payload's shape, in
    place, with one read-back for all (``packed_accum_all``).  ``num``
    starts at -0.0, so the fold's ``num + 1 * v`` keeps every held value's
    bits, a held -0.0 included, and an empty coordinate ends at +0.0
    (-0 + +0 = +0): bit for bit the reference's scatter into zeros."""
    _fold_kernel.packed_accum_all([
        (num.view(-1).fill_(-0.0), den.view(-1).zero_(), ps.bitmap,
         ps.values, 1.0) for ps, num, den in decodes])


def _accumulators(ps: PackedSparse):
    """Float32 (num, den) of ``ps``'s shape on its device, to decode into."""
    return tuple(torch.empty(ps.shape, dtype=torch.float32,
                             device=ps.values.device) for _ in range(2))


def decode(ps: PackedSparse):
    """(w ⊙ m, m) of one payload in float32, by folding it into zero
    accumulators (not counted in ``COUNTERS``)."""
    num, den = _accumulators(ps)
    decode_into([(ps, num, den)])
    return num, den


def decode_tree(packed: PyTree):
    """(params, masks) trees of one packed tree, each payload decoded once
    with one read-back for the tree — one tree unpack
    (``sparse.packed/tree_unpacks``, a ``codec.unpack_tree`` span)."""
    with span("codec.unpack_tree", track="codec"):
        _packed.OBS.counter("tree_unpacks").inc()
        decodes = []

        def start(ps):
            num, den = _accumulators(ps)
            decodes.append((ps, num, den))
            return num, den

        out = tree_unzip(tree_map(start, packed, is_leaf=is_packed))
        decode_into(decodes)
        return out


def packed_gossip_one(own_params: PyTree, own_mask: PyTree,
                      neighbor_packed: Sequence[PyTree]) -> PyTree:
    """Intersection-weighted gossip for ONE client from packed neighbour
    payloads (paper Alg. 1 line 7) — O(degree · nnz) folds, bit-identical
    to ``gossip_average_one`` on the densified neighbours."""
    folds = []

    def start(w, m, *packs):
        mf = m.to(w.dtype)
        num = w * mf
        den = mf.clone()
        folds.extend((num, den, p, 1.0) for p in packs)
        return num, den, mf

    acc = tree_map(start, own_params, own_mask, *neighbor_packed,
                   is_leaf=is_packed)
    _fold(folds)
    return tree_map(lambda t: _intersection_avg(*t), acc,
                    is_leaf=lambda t: isinstance(t, tuple))


def packed_axpy(acc: PyTree, packed: PyTree, alpha: float) -> PyTree:
    """acc + alpha * densify(packed), leafwise, without materializing the
    densified payload outside the fused fold."""
    folds = []

    def start(a, p):
        num = a.clone()
        folds.append((num, torch.zeros_like(a), p, alpha))
        return num

    out = tree_map(start, acc, packed, is_leaf=is_packed)
    _fold(folds)
    return out
