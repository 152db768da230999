"""Intersection-weighted gossip averaging (paper Alg. 1 line 7, Fig. 1b;
reference ``repro.core.gossip``).

Client k forms, coordinate by coordinate,

    w_k <- ( (w_k + sum_j w_j) / max(m_k + sum_j m_j, 1) ) ⊙ m_k

over its own and its neighbours' masked models.  Two forms:

* ``gossip_average_one`` — one client: each leaf goes through
  ``kernels.gossip_avg`` (one CUDA launch per leaf on the GPU, the plain
  version on the CPU), which sums in stack order (self first, neighbours
  in the caller's order), exactly the reference loop's order.
* ``gossip_average_stacked`` — every client at once over a stacked client
  axis, as adjacency einsums (``scale.stacked.masked_gossip_stacked``);
  ``plain_gossip_stacked`` is D-PSGD's row-stochastic mix in the same
  form.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.gossip_avg import gossip_avg
from repro_torch.utils.tree import tree_map

PyTree = Any


def _intersection_avg(num: torch.Tensor, den: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """num/den on held coordinates, zero elsewhere (the gossip kernel with
    one row).  den>=1 wherever mask=1."""
    return gossip_avg([num], [den.to(num.dtype)], mask.to(num.dtype))


def gossip_average_one(
    own_params: PyTree,
    own_mask: PyTree,
    neighbor_params: list[PyTree],
    neighbor_masks: list[PyTree],
) -> PyTree:
    """Single-client intersection-weighted gossip.  Every model must already
    be masked (``w == w ⊙ m``), as the DisPFL state always is."""

    def one(w, m, *rest):
        n = len(rest) // 2
        ws, ms = rest[:n], rest[n:]
        return gossip_avg([w, *ws], [x.to(w.dtype) for x in (m, *ms)],
                          m.to(w.dtype))

    return tree_map(one, own_params, own_mask, *neighbor_params,
                    *neighbor_masks)


def gossip_average_stacked(stacked_params: PyTree, stacked_masks: PyTree,
                           adjacency) -> PyTree:
    """All-client intersection-weighted gossip: leaves carry a leading
    client dim K, ``adjacency`` is the (K, K) receive matrix (``A[k, j] =
    1`` iff k receives j; unit diagonal).  The fp32 adjacency einsum of
    ``masked_gossip_stacked`` (imported here: ``repro_torch.scale`` imports
    this module)."""
    from repro_torch.scale.stacked import masked_gossip_stacked

    return masked_gossip_stacked(stacked_params, stacked_masks, adjacency,
                                 reduction="einsum")


def plain_gossip_stacked(stacked_params: PyTree, mixing) -> PyTree:
    """D-PSGD style gossip ``w_k <- sum_j W[k, j] w_j`` with a
    row-stochastic (K, K) ``mixing``, as an einsum over the client dim."""
    from repro_torch.scale.stacked import plain_mix_stacked

    return plain_mix_stacked(stacked_params, mixing, reduction="einsum")
