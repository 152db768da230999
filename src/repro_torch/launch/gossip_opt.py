"""The ring gossip (reference ``repro.launch.gossip_opt``).

``ppermute_gossip`` is the ring-topology intersection gossip (paper Fig.
2b, Table 2) as ``torch.roll`` over the stacked client dim: each client
mixes its own row with the rows ``±1..±hops`` away.  In the reference the
roll over a sharded client dim lowers to a collective-permute between
neighbouring devices; here the K clients share one card, so the roll is a
copy on it.  The reference's wire rounding is kept: each weight is masked
and rounded to its storage dtype before it is summed (bf16 weights travel
as bf16), and masks are widened only for the sum, so the result is the
reference's expression by expression.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_map

PyTree = Any


def ppermute_gossip(params: PyTree, masks: PyTree, plan=None,
                    degree: int = 2) -> PyTree:
    """Ring intersection-weighted gossip over the stacked client dim.

    degree=2 mixes the ±1 ring neighbours; degree=2h mixes ±1..±h.  Sums
    are fp32, hop by hop, +h before -h, as in the reference; at K=2 the
    +1 and -1 neighbour is the same client and is counted twice there
    too.  ``plan`` is unused (the reference takes it for its mesh)."""
    hops = max(1, degree // 2)

    def mix(w, m):
        mf = m.float()
        wm = (w.float() * mf).to(w.dtype)          # masked, wire dtype
        num = wm.float()
        den = mf
        for h in range(1, hops + 1):
            num = num + torch.roll(wm, h, 0).float() \
                + torch.roll(wm, -h, 0).float()
            den = den + torch.roll(m, h, 0).float() \
                + torch.roll(m, -h, 0).float()
        return ((num / torch.clamp_min(den, 1.0)) * mf).to(w.dtype)

    return tree_map(mix, params, masks)
