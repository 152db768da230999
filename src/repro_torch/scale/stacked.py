"""Stacked-client state and the stacked compute primitives (reference
``repro.scale.stacked``).

Every function here works on *client-stacked* trees: each leaf carries a
leading K (client) dimension, so one call does for all clients what the
loop engine does client by client.

Primitives
----------
``masked_gossip_stacked``   DisPFL's intersection-weighted gossip over the K
                            dim.  ``"einsum"``: num/den as adjacency matmuls
                            (fp32, TF32 off; another summation order than
                            the loop, so equal to it within fp32 rounding).
                            ``"ordered"``: the gossip kernel once per
                            receiver and leaf over its own row then its
                            in-neighbours in ascending index — the loop's
                            order, bit for bit.
``plain_mix_stacked``       row-stochastic mixing (D-PSGD Metropolis), same
                            two reductions.
``stacked_sgd_step``        one vmapped SGD step of all clients
``stacked_local_phase``     the local SGD phase for all clients at once
                            (``torch.func.vmap`` of ``grad`` over the
                            model), ragged schedules padded, padded steps
                            exact no-ops, momentum as stacked state.
``stacked_evolve_exact``    Alg. 2 batched over clients with exact counts
                            (stable argsort; equal to ``core.evolve``).
``stacked_prune_regrow_threshold``
                            the threshold form for large leaves: sort-picked
                            thresholds, then the prune/regrow kernel once
                            per sparsifiable leaf.

Stacked packed payloads
-----------------------
``StackedPacked`` is the K-client form of ``PackedSparse``: bitmaps (K,
n_words), values right-padded to the largest nnz, a (K,) nnz vector — all
built on the device, byte-identical to the reference's.  ``fold_stacked``
folds payload k into accumulator row k with the stacked fold kernel, one
launch per leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.kernels.gossip_avg import gossip_avg
from repro_torch.kernels.packed_accum import packed_accum_rows
from repro_torch.kernels.prune_regrow import prune_regrow_rows, sort_thresholds
from repro_torch.models.common import softmax_xent
from repro_torch.optim.sgd import SGDConfig, masked_sgd_step, sgd_step
from repro_torch.sparse.packed import (
    PackedSparse,
    is_packed,
    pack_bits_rows,
    unpack_bits_rows,
)
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_unzip,
)

PyTree = Any

REDUCTIONS = ("einsum", "ordered")


def check_reduction(reduction: str) -> None:
    if reduction not in REDUCTIONS:
        raise ValueError(
            f"reduction must be one of {REDUCTIONS}, got {reduction!r}")


def stacked_state_from_numpy(state: PyTree, device="cpu") -> PyTree:
    """A reference ``ScaleEngine`` state (its stacked trees, each leaf
    through ``np.asarray``) as the port's stacked state on ``device``, bit
    for bit.  Every leaf must share one leading K."""
    ks = {np.asarray(a).shape[0] for a in tree_leaves(state)}
    if len(ks) != 1:
        raise ValueError(f"not a stacked state: leading dims {sorted(ks)}")
    return tree_from_numpy(state, device)


# ---------------------------------------------------------------------------
# Stacked gossip folds
# ---------------------------------------------------------------------------


def _on_device(matrix, dtype, tree) -> torch.Tensor:
    """A (K, K) host or device matrix as one tensor on the tree's device."""
    return torch.as_tensor(matrix, dtype=dtype,
                           device=tree_leaves(tree)[0].device)


def in_neighbour_index(adjacency, width: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """The ``ordered`` gossip's (K, J) int64 read index on ``device``: row
    k is ``[k, *in-neighbours ascending]``, then ``K`` (the pad row, which
    the mix fills with -0.0) up to ``width`` columns; ``width`` defaults to
    the largest in-degree plus one.  The (K, K) adjacency is read on the
    host here, once, so a captured mix takes each round's topology as a
    tensor of one shape: with the topology's bound as ``width``
    (``core.topology.max_in_degree``) one capture serves every round,
    drops included."""
    a = np.asarray(adjacency.cpu() if isinstance(adjacency, torch.Tensor)
                   else adjacency)
    k = a.shape[0]
    rows = [[r] + [j for j in range(k) if a[r, j] > 0 and j != r]
            for r in range(k)]
    j = max(map(len, rows)) if width is None else int(width)
    if any(len(r) > j for r in rows):
        raise ValueError(f"a receiver mixes {max(map(len, rows))} rows, "
                         f"more than the index's width {j}")
    return torch.tensor([r + [k] * (j - len(r)) for r in rows],
                        dtype=torch.int64, device=device)


def masked_gossip_stacked(params: PyTree, masks: PyTree, adjacency,
                          reduction: str = "einsum",
                          accum_dtype: torch.dtype = torch.float32,
                          receivers: Optional[tuple[int, int]] = None
                          ) -> PyTree:
    """Intersection-weighted gossip over the stacked client dim.

    ``adjacency`` is the (K, K) receive matrix with unit diagonal (numpy or
    a float tensor): client k mixes every j with ``A[k, j] > 0``, itself
    included.  The state must be masked (``w == w ⊙ m``), as DisPFL's
    always is; the result is re-masked by each receiver's own mask.
    ``accum_dtype`` is the einsum's operand and result type (bfloat16 halves
    its bytes); the division and the re-mask are fp32.

    The ``ordered`` reduction accumulates in the state's dtype.  It also
    takes ``in_neighbour_index``'s (K, J) int64 tensor in place of the
    matrix, and then reads nothing on the host.  Per leaf it gathers the
    K * J rows it reads, weights and masks, into one (K, J, ...) stack on
    the device, the index's pad slots reading a row of -0.0, and launches
    the gossip kernel once per receiver over its J rows.  ``x + -0.0 ==
    x`` for every x, so the pads leave each sum's bits as the real rows
    alone give them.

    ``receivers=(k0, k1)`` mixes receivers ``k0:k1`` only, over all K
    senders, and returns their (k1 - k0, ...) rows: a client-sharded round
    gathers the K senders and mixes its own clients.  ``ordered`` reads
    rows ``k0:k1`` of the global index, so each receiver's launch, and its
    bits, are the unsharded round's; ``einsum`` multiplies rows ``k0:k1``
    of the adjacency, a GEMM of another M, equal to the unsharded mix
    within fp32 rounding."""
    check_reduction(reduction)
    k0, k1 = receivers or (0, tree_leaves(params)[0].shape[0])
    if reduction == "einsum":
        a = _on_device(adjacency, accum_dtype, params)[k0:k1]

        def one(w, m):
            mf = m.to(accum_dtype)
            num = torch.einsum("kj,j...->k...", a, w.to(accum_dtype) * mf)
            den = torch.einsum("kj,j...->k...", a, mf)
            mix = num.float() / torch.clamp_min(den.float(), 1.0)
            return (mix * mf[k0:k1].float()).to(w.dtype)

        return tree_map(one, params, masks)

    index = (adjacency if isinstance(adjacency, torch.Tensor)
             and adjacency.dtype == torch.int64 else
             in_neighbour_index(adjacency,
                                device=tree_leaves(params)[0].device))
    k, j = k1 - k0, index.shape[1]
    flat = index[k0:k1].reshape(-1)

    def one(w, m):
        pad = w.new_full((1, *w.shape[1:]), -0.0)
        wp = torch.cat([w, pad])
        mp = torch.cat([m.to(w.dtype), pad])
        gw = wp.index_select(0, flat).reshape(k, j, *w.shape[1:])
        gm = mp.index_select(0, flat).reshape(k, j, *w.shape[1:])
        return torch.stack([gossip_avg(list(gw[r]), list(gm[r]), mp[k0 + r])
                            for r in range(k)])

    return tree_map(one, params, masks)


def plain_mix_stacked(params: PyTree, mixing, reduction: str = "einsum",
                      receivers: Optional[tuple[int, int]] = None) -> PyTree:
    """Row-stochastic mixing ``w_k <- sum_j W[k, j] w_j`` over the K dim
    (D-PSGD / Metropolis).  ``"ordered"`` adds the terms in ascending
    sender index, one rounded multiply and add each.  ``receivers=(k0,
    k1)`` mixes rows ``k0:k1`` only, as in ``masked_gossip_stacked``."""
    check_reduction(reduction)
    mix = _on_device(mixing, torch.float32, params)
    if receivers is not None:
        mix = mix[receivers[0]:receivers[1]]

    def one(w):
        wm = mix.to(w.dtype)
        if reduction == "einsum":
            return torch.einsum("kj,j...->k...", wm, w)
        bshape = (wm.shape[0],) + (1,) * (w.dim() - 1)
        acc = w.new_zeros((wm.shape[0], *w.shape[1:]))
        for j in range(w.shape[0]):
            acc = acc + wm[:, j].reshape(bshape) * w[j]
        return acc

    return tree_map(one, params)


# ---------------------------------------------------------------------------
# Stacked local phase and gradients
# ---------------------------------------------------------------------------


def _grad_fn(apply_fn: Callable) -> Callable:
    def loss(p, x, y):
        return softmax_xent(apply_fn(p, x), y)

    return torch.func.grad(loss)


def stacked_grads(apply_fn: Callable, params: PyTree, x: torch.Tensor,
                  y: torch.Tensor) -> PyTree:
    """Per-client dense gradients of the mean cross-entropy on one (K, B,
    ...) batch, vmapped over the stacked params."""
    return torch.func.vmap(_grad_fn(apply_fn))(params, x, y)


def stacked_sgd_step(apply_fn: Callable, opt: SGDConfig) -> Callable:
    """``step(w, st, m, x, y, lr, alive) -> (w, st)``: one vmapped SGD step
    of K stacked clients on the batches ``x``, ``y`` (K, B, ...) — masked
    with stacked ``m``, plain with ``m=None`` — where a client whose
    ``alive[k]`` is False keeps ``w`` and ``st`` exactly (``torch.where``).

    The update rule is the loop's (``optim.sgd.masked_sgd_step`` or
    ``sgd_step``).  Conv weights stay HWIO: the model permutes inside the
    vmapped function, per client."""
    grad = _grad_fn(apply_fn)

    def step(w, st, m, x, y, lr, alive):
        if m is None:
            w2, st2 = sgd_step(w, grad(w, x, y), st, opt, lr)
        else:
            w2, st2 = masked_sgd_step(w, grad(w, x, y), m, st, opt, lr)
        keep = lambda o, n: torch.where(alive, n, o)  # noqa: E731
        return tree_map(keep, w, w2), tree_map(keep, st, st2)

    def vstep(w, st, m, x, y, lr, alive):
        # an unmasked step passes no mask tree: vmap maps none of it
        return torch.func.vmap(step, in_dims=(
            0, 0, None if m is None else 0, 0, 0, None, 0))(
                w, st, m, x, y, lr, alive)

    return vstep


def stacked_local_phase(apply_fn: Callable, opt: SGDConfig, params: PyTree,
                        masks: Optional[PyTree], bx: torch.Tensor,
                        by: torch.Tensor, live: torch.Tensor,
                        lr: float) -> PyTree:
    """The local phase for all K clients: for each of the S padded steps,
    ``stacked_sgd_step`` on batches ``bx[:, s]``, ``by[:, s]``.  A step with
    ``live[k, s]`` False is an exact no-op for client k, so ragged
    schedules pad with recycled batches; momentum starts at zero, stacked
    per client, as the loop's ``init_sgd``."""
    vstep = stacked_sgd_step(apply_fn, opt)
    st = ({"mu": tree_map(torch.zeros_like, params)}
          if opt.momentum != 0.0 else {})
    for s in range(bx.shape[1]):
        params, st = vstep(params, st, masks, bx[:, s], by[:, s], lr,
                           live[:, s])
    return params


# ---------------------------------------------------------------------------
# Stacked mask evolution — exact and threshold forms
# ---------------------------------------------------------------------------


def _topk_rows(scores: torch.Tensor, k) -> torch.Tensor:
    """Per-row {0,1} selection of the ``k`` largest scores: a stable
    descending argsort (ties to the lowest index, as ``core.evolve``), then
    rank < k, so the count may be an int or a device tensor."""
    order = torch.argsort(-scores, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(
        scores.shape[1], device=scores.device).expand_as(order))
    return (ranks < k).to(torch.float32)


def stacked_evolve_exact(params: PyTree, masks: PyTree, grads: PyTree,
                         counts: dict) -> tuple[PyTree, PyTree]:
    """Alg. 2 (magnitude prune + gradient regrow) batched over the K dim.
    ``counts`` maps sparsifiable leaf paths to ``(n_keep, n_prune)``;
    leaves without an entry pass through.  Returns ``(masks, params)``,
    equal per client to ``core.evolve.evolve_mask_layer``."""

    def one(path, w, m, g):
        if path not in counts:
            return m, w
        n_keep, n_prune = counts[path]
        k = w.shape[0]
        mf = m.reshape(k, -1).to(torch.float32)
        neg_inf = torch.full((), float("-inf"), device=w.device)
        m_half = _topk_rows(
            torch.where(mf > 0, w.reshape(k, -1).to(torch.float32).abs(),
                        neg_inf), n_keep)
        grown = _topk_rows(
            torch.where(m_half > 0, neg_inf,
                        g.reshape(k, -1).to(torch.float32).abs()), n_prune)
        new_m = (m_half + grown).reshape(w.shape)
        return new_m.to(m.dtype), w * new_m.to(w.dtype)

    return tree_unzip(tree_map_with_path(one, params, masks, grads))


def evolve_counts_for(budgets: dict[str, int],
                      prune_rate: float) -> dict[str, tuple[int, int]]:
    """Per-round ``(n_keep, n_prune)`` per layer, ``math.ceil`` on the host
    float, exactly as ``core.evolve.evolve_mask_layer`` derives them."""
    import math

    out = {}
    for path, n_active in budgets.items():
        n_prune = int(math.ceil(prune_rate * n_active))
        out[path] = (n_active - n_prune, n_prune)
    return out


def default_threshold_sparsifiable(w: torch.Tensor) -> bool:
    """Matrix-shaped stacked leaves; stacked norm scales and biases stay
    dense."""
    return w.dim() >= 3 and w.shape[-1] >= 64 and w.shape[-2] >= 64


def stacked_prune_regrow_threshold(
    params: PyTree, masks: PyTree, grads: PyTree, prune_rate,
    density: float,
    sparsifiable: Callable[[torch.Tensor], bool] = default_threshold_sparsifiable,
) -> tuple[PyTree, PyTree]:
    """Threshold-based stacked prune/regrow.  Per client and sparsifiable
    leaf, a static budget ``n_active = max(1, round(density * n))``,
    ``n_prune = ceil(f32(prune_rate) * n_active)`` (the reference's fp32
    product, on the device: ``prune_rate`` is a float or a float32 tensor,
    so a captured step takes a new rate each call), thresholds by
    ``torch.sort`` on the device, then the
    prune/regrow kernel — one launch per leaf, on the leaf's own dtypes
    (a pair of ``kernels.prune_regrow.PAIRS``: fp32 or bf16 weights, int8
    masks on the LM steps), with no widened copy of a leaf.  The reference
    widens every leaf to fp32 first; the kernel widens each value as it
    compares, which is exact, so the results are the same.  Ties may keep
    or grow a few more coordinates than the exact form.  Returns
    ``(masks, params)``."""
    dev = tree_leaves(params)[0].device
    rate = (prune_rate.to(dev, torch.float32)
            if isinstance(prune_rate, torch.Tensor) else
            torch.full((), prune_rate, dtype=torch.float32, device=dev))

    def one(w, g, m):
        if not sparsifiable(w):
            return m, w
        k = w.shape[0]
        w2, g2, m2 = (t.reshape(k, -1).contiguous() for t in (w, g, m))
        n_active = max(1, int(round(density * w2.shape[1])))
        n_prune = torch.ceil(rate * n_active).to(torch.int64)
        th = sort_thresholds(w2, g2, m2, n_active - n_prune, n_prune)
        new_m, new_w = prune_regrow_rows(w2, g2, m2, th)
        return new_m.reshape(m.shape), new_w.reshape(w.shape)

    return tree_unzip(tree_map(one, params, grads, masks))


# ---------------------------------------------------------------------------
# Stacked packed payloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StackedPacked:
    """K clients' packed messages for one leaf.  ``bitmap`` is (K, n_words)
    int32 holding the reference's uint32 bits; ``values`` (K, max_nnz),
    each row's held values left-aligned and zero right-padded; ``nnz`` the
    (K,) int32 true counts; ``shape`` the per-client leaf shape."""

    bitmap: torch.Tensor
    values: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, ...]

    @property
    def n_clients(self) -> int:
        return int(self.bitmap.shape[0])

    @property
    def n_coords(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def is_stacked_packed(x) -> bool:
    return isinstance(x, StackedPacked)


def pack_stacked(stacked_params: PyTree,
                 stacked_masks: Optional[PyTree] = None,
                 dtype: Optional[torch.dtype] = None) -> PyTree:
    """Pack a stacked state into ``StackedPacked`` leaves on its device
    (``masks=None`` packs dense: all-ones bitmaps).  Values keep the
    state's dtype, or are cast to ``dtype`` (``torch.float16``: the wire's
    fp16 payloads, rounded to nearest even as the reference's numpy cast
    rounds them).  The values width is data-dependent, so each leaf reads
    its largest nnz back once."""

    def one(w, m):
        k = w.shape[0]
        flat = w.reshape(k, -1)
        flags = (torch.ones_like(flat, dtype=torch.bool) if m is None
                 else m.reshape(k, -1) != 0)
        nnz = flags.sum(dim=1).to(torch.int32)
        width = int(nnz.max()) if k else 0
        # each held value to its rank in the row, the rest to a spare column
        col = torch.where(flags, torch.cumsum(flags, dim=1) - 1, width)
        vals = flat if dtype is None else flat.to(dtype)
        buf = torch.zeros((k, width + 1), dtype=vals.dtype,
                          device=flat.device)
        buf.scatter_(1, col, vals)
        return StackedPacked(bitmap=pack_bits_rows(flags),
                             values=buf[:, :width].contiguous(), nnz=nnz,
                             shape=tuple(w.shape[1:]))

    if stacked_masks is None:
        return tree_map(lambda w: one(w, None), stacked_params)
    return tree_map(one, stacked_params, stacked_masks)


def unpack_stacked(packed: PyTree) -> PyTree:
    """Dense stacked state from ``StackedPacked`` leaves: held values at
    their coordinates, exact zeros elsewhere
    (``unpack_stacked(pack_stacked(w, m)) == w ⊙ m``)."""

    def one(sp: StackedPacked):
        k, width = sp.n_clients, sp.values.shape[1]
        flags = unpack_bits_rows(sp.bitmap, sp.n_coords)
        out = torch.zeros(flags.shape, dtype=sp.values.dtype,
                          device=sp.values.device)
        if width:
            rank = (torch.cumsum(flags, dim=1) - 1).clamp(0, width - 1)
            out = torch.where(flags, sp.values.gather(1, rank), out)
        return out.reshape((k,) + sp.shape)

    return tree_map(one, packed, is_leaf=is_stacked_packed)


def split_stacked(packed: PyTree) -> list[PyTree]:
    """The K individual ``PackedSparse`` trees of a stacked payload — what
    crosses a link (codec-framable, padding stripped)."""
    leaves = tree_leaves(packed, is_leaf=is_stacked_packed)
    if not leaves:
        return []
    nnz = {id(sp): sp.nnz.tolist() for sp in leaves}

    def one_client(k):
        return tree_map(
            lambda sp: PackedSparse(bitmap=sp.bitmap[k],
                                    values=sp.values[k, : nnz[id(sp)][k]],
                                    shape=sp.shape),
            packed, is_leaf=is_stacked_packed)

    return [one_client(k) for k in range(leaves[0].n_clients)]


def stack_payloads(payloads: Sequence[PyTree]) -> PyTree:
    """Inverse of ``split_stacked``: K ``PackedSparse`` trees of one
    structure (ragged nnz allowed) into one ``StackedPacked`` tree."""

    def one(*leaves: PackedSparse):
        first = leaves[0].values
        vals = torch.zeros((len(leaves), max(p.nnz for p in leaves)),
                           dtype=first.dtype, device=first.device)
        for k, p in enumerate(leaves):
            vals[k, : p.nnz] = p.values
        return StackedPacked(
            bitmap=torch.stack([p.bitmap for p in leaves]), values=vals,
            nnz=torch.tensor([p.nnz for p in leaves], dtype=torch.int32,
                             device=first.device),
            shape=leaves[0].shape)

    return tree_map(one, *payloads, is_leaf=is_packed)


def fold_stacked(num: PyTree, den: PyTree, packed: PyTree,
                 alpha: float = 1.0) -> tuple[PyTree, PyTree]:
    """Fold a stacked payload into stacked (num, den) accumulators — client
    k's payload into row k — in place, one stacked-fold launch per leaf
    (its plain version for CPU tensors); fp16 payload values are widened
    exactly into the fp32 accumulators.  Returns ``(num, den)``."""

    def one(nu, de, sp: StackedPacked):
        k = sp.n_clients
        packed_accum_rows(nu.view(k, -1), de.view(k, -1), sp.bitmap,
                          sp.values, sp.nnz, alpha)
        return nu, de

    return tree_unzip(tree_map(one, num, den, packed))


def stacked_nnz_per_client(stacked_masks: PyTree) -> list[int]:
    """Per-client nnz of a stacked mask tree (the comm-accounting input),
    read back once."""
    total = None
    for leaf in tree_leaves(stacked_masks):
        counts = (leaf != 0).reshape(leaf.shape[0], -1).sum(dim=1)
        total = counts if total is None else total + counts
    return [int(c) for c in total.tolist()]
