"""Mixture-of-Experts FFN: token-choice top-k routing with capacity dispatch
(reference ``repro.models.moe``).

Two execution paths over the same parameters:

* ``moe_dense_ref`` — every expert sees every token, weighted by gates.
  O(E) compute; exact; the test oracle.
* ``moe_apply`` — sorted capacity dispatch: tokens are stably sorted by
  expert id, packed into (E, C) buffers (static capacity C, a multiple of
  8; overflow dropped), the expert FFNs run batched, and each token sums
  its k gated expert outputs.

The reference scatters into the buffers (``buf.at[slot].set``) and
scatter-adds the combine (``y.at[tt_s].add``).  Here both are gathers, so
the function has no in-place write and runs under ``torch.func.vmap``:
buffer slot ``(e, c)`` reads sorted entry ``offsets[e] + c`` when
``c < counts[e]`` (the same entry the reference's scatter puts there), and
the combine gathers each token's k gated outputs in sorted order —
ascending expert id, the order the reference's scatter-add visits them —
and adds them one by one to a zero row (``_combine``).  The sum is
deterministic (``index_add_`` on CUDA is atomic), so a user's output does
not depend on who shares the launch, and gradients flow through the
gathers.  Top-k breaks ties toward the lower expert index, as
``lax.top_k`` does: a stable descending sort.

Over a mesh (``sharding.ctx.use_mesh_rules``; the weights a rank's
shards) the expert weights' FSDP shards are gathered over 'data'.  Where
'model' splits the expert dim (the reference's ``constrain(xb, ('expert',
...))``), the router, top-k, sort and dispatch stay replicated (a client's
tokens are not split over 'model'), each rank runs its own experts' FFN on
its rows of the (E, C, d) buffer (``split_to``), and the expert outputs are
gathered over 'model' before the combine, which then adds each token's k
terms in the same order as on one card.  The shared experts split as an
MLP (columns, then rows all-reduced).  Where the step split the client's
rows over 'data' (FSDP2D), the dispatch stays global over gathered rows
(``moe_apply``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, lecun_init, mlp_split
from repro_torch.sharding import tp


def moe_init(gen: torch.Generator, d_model: int, spec,
             dtype=torch.float32) -> dict:
    """The router stays float32 whatever ``dtype`` is (the reference's
    fp32 island: routing in ``_route`` is computed in fp32)."""
    e, de = spec.n_experts, spec.d_expert
    p = {
        "router": lecun_init(gen, (d_model, e)),
        "w_gate": lecun_init(gen, (e, d_model, de), dtype=dtype),
        "w_up": lecun_init(gen, (e, d_model, de), dtype=dtype),
        "w_down": lecun_init(gen, (e, de, d_model), fan_in=de, dtype=dtype),
    }
    if spec.n_shared > 0:
        ds = spec.d_expert * spec.n_shared
        p["shared"] = {
            "w_gate": lecun_init(gen, (d_model, ds), dtype=dtype),
            "w_up": lecun_init(gen, (d_model, ds), dtype=dtype),
            "w_down": lecun_init(gen, (ds, d_model), fan_in=ds, dtype=dtype),
        }
    return p


def _expert_ffn(p, xb, act):
    """xb: (E, C, d) -> (E, C, d), batched gated FFN over experts."""
    h = act(torch.einsum("ecd,edf->ecf", xb, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xb, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _shared_ffn(p, x, act, ds: int):
    """The shared experts' gated FFN (``ds`` hidden units); over a mesh
    split as ``common.mlp_split`` says."""
    p, y = mlp_split(p, x, act, ds, "shared experts")
    if y is not None:
        return y
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _expert_weights(p, spec, d: int):
    """``(weights, split)``: the expert FFN's weights whole over 'data'
    (their middle dim), and whether 'model' splits the expert dim."""
    e, de = spec.n_experts, spec.d_expert
    w = {"w_gate": tp.whole(p["w_gate"], 1, d),
         "w_up": tp.whole(p["w_up"], 1, d),
         "w_down": tp.whole(p["w_down"], 1, de)}
    return w, tp.split(w["w_gate"].shape[0], e)


def _route(params, xf, spec):
    """xf: (N, d) -> gates (N, k), expert ids (N, k), probs (N, E) [f32]."""
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = vals[:, :spec.top_k], idx[:, :spec.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eids, probs


def _expert_counts(eids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many of ``eids`` (any shape) pick each expert, (E,) int64."""
    experts = torch.arange(n_experts, device=eids.device)
    return (eids.reshape(-1, 1) == experts).sum(0)


def aux_load_balance_loss(probs: torch.Tensor, eids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    n, k = eids.shape
    f = _expert_counts(eids, n_experts).float() / (n * k)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def capacity_for(n_tokens: int, spec) -> int:
    c = int(math.ceil(n_tokens * spec.top_k / spec.n_experts
                      * spec.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _combine(contrib_s: torch.Tensor, order: torch.Tensor, n: int,
             k: int) -> torch.Tensor:
    """(N, d): each token's k terms of ``contrib_s`` (N*k, d, in the sorted
    order ``order`` gave) added one by one to a zero row in sorted order —
    ascending expert id, since a token's k experts are distinct — as the
    reference's ``y.at[tt_s].add`` adds them."""
    idx = torch.sort(torch.argsort(order).reshape(n, k), dim=1).values
    terms = contrib_s[idx]                                        # (N, k, d)
    y = torch.zeros_like(terms[:, 0])
    for j in range(k):
        y = y + terms[:, j]
    return y


def moe_apply(params, x: torch.Tensor, spec, act_name: str = "silu"):
    """Sorted capacity dispatch.  x: (B, S, d) -> (y, aux_loss).  Where a
    meshed step split the rows over 'data' (``sharding.tp.rows_split``),
    ``x`` is this rank's rows: the routing, the dispatch, the combine and
    the aux loss run on every row, gathered over 'data' (the capacity,
    the top-k order and the aux loss are functions of the client's whole
    token set, as the reference's replicated ``xb``), the experts' FFN on
    this rank's slots of the capacity, the shared experts on this rank's
    rows; then this rank's rows of the output."""
    act = activation(act_name)
    rows = tp.rows_split()
    own = x
    if rows:
        x = tp.gather_from(x, "data", 0)
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    gates, eids, probs = _route(params, xf, spec)
    k = spec.top_k
    cap = capacity_for(n, spec)
    e = spec.n_experts

    ee = eids.reshape(n * k)
    tt = torch.arange(n, device=x.device).repeat_interleave(k)
    order = torch.argsort(ee, stable=True)
    ee_s, tt_s = ee[order], tt[order]
    counts = _expert_counts(ee_s, e)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=x.device) - offsets[ee_s]
    keep = pos_in_e < cap

    # dispatch: slot (e, c) holds sorted entry offsets[e] + c if c < counts[e]
    c_idx = torch.arange(cap, device=x.device)
    filled = c_idx[None, :] < counts[:, None]                     # (E, C)
    src = torch.clamp_max(offsets[:, None] + c_idx[None, :], n * k - 1)
    xb = torch.where(filled[..., None], xf[tt_s[src]],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    experts, split = _expert_weights(params, spec, d)

    def ffn(xb):
        if not rows:
            return _expert_ffn(experts, xb, act)
        # the FFN's slots split over 'data' where the rows are (the
        # weights' gradients summed over 'data', sharding.tp), padded with
        # empty slots to a multiple of |data|: an empty slot's output and
        # gradient are zero
        pad = -cap % tp.axis_size("data")
        yb = tp.gather_from(_expert_ffn(experts, tp.split_to(
            F.pad(xb, (0, 0, 0, pad)), "data", 1), act), "data", 1)
        return yb[:, :cap]

    if split:
        yb = tp.gather_from(ffn(tp.split_to(xb, dim=0)), dim=0)
    else:
        tp.replicated("experts")
        yb = ffn(xb)
    yb = yb.reshape(e * cap, d)

    # combine: sorted entry i reads its slot, gated; kept entries only
    slot = ee_s * cap + torch.clamp_max(pos_in_e, cap - 1)
    gg_s = gates.reshape(n * k).to(x.dtype)[order]
    contrib_s = torch.where(keep[:, None], yb[slot],
                            torch.zeros((), dtype=x.dtype, device=x.device))
    y = _combine(contrib_s * gg_s[:, None], order, n, k)

    if rows:
        y = tp.split_to(y.reshape(b, s, d), "data", 0)
        b, xf = own.shape[0], own.reshape(-1, d)
        y = y.reshape(-1, d)
    if spec.n_shared > 0:
        y = y + _shared_ffn(params["shared"], xf, act,
                            spec.d_expert * spec.n_shared)
    aux = aux_load_balance_loss(probs, eids, e) * spec.router_aux_coef
    return y.reshape(b, s, d), aux


def moe_dense_ref(params, x: torch.Tensor, spec, act_name: str = "silu"):
    """Oracle: every expert computes every token; exact top-k combine."""
    act = activation(act_name)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, eids, probs = _route(params, xf, spec)
    h = act(torch.einsum("nd,edf->enf", xf, params["w_gate"]))
    h = h * torch.einsum("nd,edf->enf", xf, params["w_up"])
    ye = torch.einsum("enf,efd->end", h, params["w_down"])
    onehot = (eids[..., None] == torch.arange(spec.n_experts,
                                              device=x.device)).to(x.dtype)
    w = (onehot * gates[..., None].to(x.dtype)).sum(1)           # (N, E)
    y = torch.einsum("ne,end->nd", w, ye)
    if spec.n_shared > 0:
        y = y + _shared_ffn(params["shared"], xf, act,
                            spec.d_expert * spec.n_shared)
    aux = (aux_load_balance_loss(probs, eids, spec.n_experts)
           * spec.router_aux_coef)
    return y.reshape(b, s, d), aux
