"""The ring gossip (reference ``repro.launch.gossip_opt``).

``ppermute_gossip`` is the ring-topology intersection gossip (paper Fig.
2b, Table 2) as ``torch.roll`` over the stacked client dim: each client
mixes its own row with the rows ``±1..±hops`` away.  The reference's wire
rounding is kept: each weight is masked and rounded to its storage dtype
before it is summed (bf16 weights travel as bf16), and masks travel as
int8 and are widened only for the sum, so the result is the reference's
expression by expression.

On plain tensors the K clients share one card and the roll is a copy on
it.  On ``DTensor``s whose client dim is sharded over the client axes
(('pod','data') or ('data',), pod-major) the roll is the reference's
collective-permute: each rank sends its ring neighbours only the rows the
roll carries across its shard boundary and receives theirs, one
``all_to_all_single`` a shift over the client axes' group with every other
split empty (a wire op that gloo carries for CPU and CUDA tensors, NCCL
carries, and a fake process group traces); nothing else of the K clients
travels.  The received rows are the roll's rows bit for bit, so the mix
equals the roll of the whole stack bit for bit.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def _mix_rows(wm, m, roll_w, roll_m, hops):
    """The intersection average of one leaf from its masked wire rows
    ``wm`` and its int8 mask ``m``; ``roll_w(s)`` and ``roll_m(s)`` are
    their rolls by ``s`` over the client dim.  Sums are fp32, hop by hop,
    +h before -h."""
    mf = m.float()
    num = wm.float()
    den = mf
    for h in range(1, hops + 1):
        num = num + roll_w(h).float() + roll_w(-h).float()
        den = den + roll_m(h).float() + roll_m(-h).float()
    return (num / torch.clamp_min(den, 1.0)) * mf


def ppermute_gossip(params: PyTree, masks: PyTree, plan=None,
                    degree: int = 2) -> PyTree:
    """Ring intersection-weighted gossip over the stacked client dim.

    degree=2 mixes the ±1 ring neighbours; degree=2h mixes ±1..±h.  Sums
    are fp32, hop by hop, +h before -h, as in the reference; at K=2 the
    +1 and -1 neighbour is the same client and is counted twice there
    too.  ``plan`` is unused (the reference takes it for its mesh; a
    ``DTensor`` carries its own).  Params and masks that are ``DTensor``s
    take the sharded ring and come back with their placements."""
    hops = max(1, degree // 2)
    leaves = tree_leaves(params)
    if leaves and _is_dtensor(leaves[0]):
        return _sharded_gossip(params, masks, hops)

    def mix(w, m):
        wm = (w.float() * m.float()).to(w.dtype)          # masked, wire dtype
        return _mix_rows(wm, m, lambda s: torch.roll(wm, s, 0),
                         lambda s: torch.roll(m, s, 0), hops).to(w.dtype)

    return tree_map(mix, params, masks)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class ClientRing:
    """The ring over the client dim of a ``DTensor`` layout: the mesh dims
    that shard dim 0 (``Shard(0)``), their process group (flattened,
    pod-major, where there are two: DTensor's order of the rows) holding
    this rank's 'model' (and other) coordinates, its size G and this
    rank's place ``g`` in it.  Row ``i`` of the K clients lives on ring
    position ``i // n`` (n = K / G rows a rank)."""

    def __init__(self, mesh, placements, k: int):
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        from torch.utils._python_dispatch import _disable_current_modes

        names = [mesh.mesh_dim_names[i] for i, p in enumerate(placements)
                 if p == Shard(0)]
        self.size = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                              for a in names)
        if k % self.size:
            raise ValueError(f"K={k} is not split evenly over {self.size} "
                             "ranks")
        self.n = k // self.size
        self.group, self.g = None, 0
        if self.size > 1:
            # a flattened mesh is made of tensors: outside any mode (a fake
            # tensor mode traces the dry run)
            with _disable_current_modes():
                sub = mesh[tuple(names)]
                self.group = (sub._flatten() if len(names) > 1
                              else sub).get_group()
            self.g = dist.get_rank(self.group)

    def segments(self, shift: int):
        """The roll by ``shift`` as two transfers, each (rows this rank
        sends, ring offset of the receiver, where the same transfer from
        the sender at minus that offset lands): the receiver's rows are its
        sender's last ``r`` rows, then the next sender's first ``n - r``."""
        q, r = divmod(shift % (self.n * self.size), self.n)
        return ((slice(self.n - r, self.n), q + 1, slice(0, r)),
                (slice(0, self.n - r), q, slice(r, self.n)))


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1).view(torch.uint8)


def ring_roll(ring: ClientRing, tensors: list, shifts: list) -> dict:
    """``torch.roll(x, s, 0)`` of the whole client stack, restricted to
    this rank's rows, for every local tensor ``x`` in ``tensors`` and every
    shift in ``shifts``: returns ``{(i, s): rows}``.  One shift is one
    ``all_to_all_single`` over the ring's group, its splits zero but for
    the (at most two) ring neighbours the roll names: each neighbour gets
    the rows of every tensor that cross to it, as raw bytes in the
    tensors' own dtypes.  ``utils.collectives`` books it as the
    collective-permute it is.  A segment that stays on this rank is a local
    copy."""
    import torch.distributed as dist

    from repro_torch.utils.collectives import booked_as

    rolled = {}
    for s in shifts:
        bufs = [torch.empty_like(x) for x in tensors]
        send = [[] for _ in range(ring.size)]
        recv = [None] * ring.size
        for src, off, dst in ring.segments(s):
            if src.stop == src.start:
                continue
            to, frm = (ring.g + off) % ring.size, (ring.g - off) % ring.size
            if to == ring.g:
                for buf, x in zip(bufs, tensors):
                    buf[dst] = x[src]
                continue
            send[to] = [_bytes(x[src]) for x in tensors]
            recv[frm] = dst
        if any(send):
            ins_n = [sum(t.numel() for t in part) for part in send]
            ins = torch.cat([t for part in send for t in part])
            outs_n = [0] * ring.size
            for f, dst in enumerate(recv):
                if dst is not None:
                    outs_n[f] = sum(
                        (dst.stop - dst.start) * x[0].numel()
                        * x.element_size() for x in tensors)
            out = torch.empty(sum(outs_n), dtype=torch.uint8,
                              device=ins.device)
            with booked_as("collective-permute"):
                dist.all_to_all_single(out, ins, outs_n, ins_n,
                                       group=ring.group)
            at = 0
            for f, dst in enumerate(recv):
                if dst is None:
                    continue
                for buf, x in zip(bufs, tensors):
                    shape = (dst.stop - dst.start,) + tuple(x.shape[1:])
                    nb = math.prod(shape) * x.element_size()
                    buf[dst] = out[at:at + nb].view(x.dtype).view(shape)
                    at += nb
        for i, buf in enumerate(bufs):
            rolled[(i, s)] = buf
    return rolled


def _sharded_gossip(params: PyTree, masks: PyTree, hops: int) -> PyTree:
    """The ring on ``DTensor`` leaves: per leaf, this rank's masked wire
    rows and int8 mask rows go to the ring neighbours the roll names; the
    mix is ``_mix_rows`` over the local rows and the received ones.  The
    leaves may be sharded over other mesh dims too ('model'): a ring peer
    holds the same shard of its rows, so only this rank's shard of each
    boundary row travels."""
    from torch.distributed.tensor import DTensor

    from torch.distributed.tensor import Shard

    ws, ms = tree_leaves(params), tree_leaves(masks)
    first = ws[0]
    lead = [p == Shard(0) for p in first.placements]
    if any([p == Shard(0) for p in x.placements] != lead for x in ws + ms):
        raise ValueError("the leaves' client dims are not sharded alike")
    ring = ClientRing(first.device_mesh, first.placements, first.shape[0])
    local_w = [w.to_local() for w in ws]
    local_m = [m.to_local() for m in ms]
    wire = [(w.float() * m.float()).to(w.dtype)
            for w, m in zip(local_w, local_m)]
    shifts = [s for h in range(1, hops + 1) for s in (h, -h)]
    rolled = ring_roll(ring, wire + local_m, shifts)
    n = len(wire)
    mixed = [DTensor.from_local(
        _mix_rows(wm, m, lambda s, i=i: rolled[(i, s)],
                  lambda s, i=i: rolled[(n + i, s)], hops).to(w.dtype),
        w.device_mesh, w.placements, run_check=False, shape=w.shape,
        stride=w.stride())
        for i, (w, wm, m) in enumerate(zip(ws, wire, local_m))]
    it = iter(mixed)
    return tree_map(lambda _: next(it), params)
