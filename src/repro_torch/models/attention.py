"""GQA/MQA attention with RoPE, optional qk-norm, sliding windows and a KV
cache (reference ``repro.models.attention``).

Covers every assigned attention variant: GQA grouping, MQA (n_kv = 1),
qk_norm, sliding-window local layers, bidirectional encoder attention and
cross-attention into encoder outputs, in the full-sequence training pass,
the prefill (writes the cache) and the one-token decode (reads the cache,
writes position ``pos``).  ``_sdpa`` is written as the reference writes it
(GQA as ``(b, sq, hkv, g, dh)``, so head ``h = kv * g + gi``; fp32
softmax; masking by ``where(mask, s, -1e30)``) — its rounding is the
parity target, so no fused attention replaces it.

Shapes: x (B, S, d).  Cache: {'k': (B, S_max, Hkv, Dh), 'v': same}.  The
prefill and the decode return a new cache built functionally (a
concatenation; a ``torch.where`` over the write position), never written
in place, so the forward runs under ``torch.func.vmap`` with a batched
``pos``.

Over a mesh (a ``sharding.ctx.use_mesh_rules`` context: the weights and
the cache a rank's local shards) ``attention`` gathers the weights' FSDP
shards over 'data' and, where 'model' has more than one rank, runs
``_attention_split``: the core split over q heads where |model| divides
``n_heads`` (a rank takes its heads and the kv heads of their GQA groups;
the k/v columns are gathered over 'model' where their split cuts a kv
head), else the core replicated on gathered q/k/v; then the o-proj's row
slice and an all-reduce (``sharding.tp``).  The KV cache stays at its
placements (``sharding.rules.cache_spec``): every kv head, head_dim split
over 'model' where |model| divides it, the sequence over 'data' under the
``kv_seq`` rule (long-context decode), every row.  The prefill writes
each rank's shard of the new k/v (an all-to-all over 'model' from a
split core's kv heads, a local slice of whole k/v); the decode reads the
cache on head_dim shards, its scores' partial sums all-reduced over
'model', each rank's chunk of the sequence combined over 'data'
flash-decoding style (``_sdpa_cached``).  Where the step split the rows
over 'data' (FSDP2D), a rank computes its rows and gathers the new k/v of
every row over 'data' into its cache.  On one card, and on 1-rank axes,
the code below ``_attention_split`` runs unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (
    apply_rope,
    column_dense,
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    whole_columns,
)
from repro_torch.sharding import ctx, tp

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, cfg.use_bias,
                         dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, cfg.use_bias,
                         dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, cfg.use_bias,
                         dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, cfg.use_bias,
                         dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, gen.device, dtype)
        p["k_norm"] = rmsnorm_init(dh, gen.device, dtype)
    return p


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                  device=None) -> dict:
    dh = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(params, x, cfg, positions):
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = dense(params["wq"], x).reshape(b, s, cfg.n_heads, dh)
    k = dense(params["wk"], x).reshape(b, s, cfg.n_kv_heads, dh)
    v = dense(params["wv"], x).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, cfg, mask):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,Hkv,Dh); mask: (B,Sq,Sk) or (Sq,Sk) bool."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, dh)
    scale = dh ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, dh)


def _local_attention(q, k, v, cfg, window: int):
    """Banded sliding-window attention for full-sequence passes.

    Queries in block i attend only to keys in blocks i-1 and i (window ==
    the block width covers exactly that span), so score tensors are (B, nb,
    W, 2W) instead of (B, S, S).  Equal to the masked full-attention path up
    to the softmax's rounding over the shorter rows.
    """
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    w = window
    nb = s // w
    g = h // hkv
    scale = dh ** -0.5
    qb = q.reshape(b, nb, w, hkv, g, dh)
    kb = k.reshape(b, nb, w, hkv, dh)
    vb = v.reshape(b, nb, w, hkv, dh)
    # keys/values from the previous block and own block: (B, nb, 2W, Hkv, D)
    prev_k = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1)
    prev_v = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1)
    k2 = torch.cat([prev_k, kb], 2)
    v2 = torch.cat([prev_v, vb], 2)
    scores = torch.einsum("bnqkgd,bnskd->bnkgqs", qb, k2).float() * scale
    # positions within the 2W span: query i (local) = global w + i of span
    dev = q.device
    qpos = w + torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)
    # first block has no previous block: mask out the padded keys
    first = torch.arange(nb, device=dev)[:, None, None] == 0
    valid = torch.where(first, mask[None] & (kpos >= w)[None], mask[None])
    scores = torch.where(valid[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=dev))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", probs, v2)
    return out.reshape(b, s, h, dh)


def causal_mask(sq: int, sk: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) bool; query i (global position offset+i) may see key j iff
    j <= offset+i and (window==0 or j > offset+i-window)."""
    qpos = offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def _whole_weights(params, d: int) -> dict:
    """The attention weights whole over 'data' (FSDP2D plans shard the
    rows of wq/wk/wv and the columns of wo there)."""
    out = dict(params)
    for name in ("wq", "wk", "wv"):
        out[name] = {**params[name], "w": tp.whole(params[name]["w"], 0, d)}
    out["wo"] = {**params["wo"], "w": tp.whole(params["wo"]["w"], 1, d)}
    return out


def _split_norm(norm_params, split: bool) -> dict:
    """A replicated norm scale applied to this rank's heads only: through
    ``copy_to``, so its gradient sums every rank's heads."""
    if not split:
        return norm_params
    return {"scale": tp.copy_to(norm_params["scale"])}


def _attention_split(params, x, positions, cfg, window, cache, pos, cross_kv,
                     bidirectional, cross_cached):
    """``attention`` over a mesh where 'model' has m > 1 ranks, or where
    the cache is split over 'data' (see the module's docstring).  Heads
    split where m divides ``n_heads`` and a rank's ``hl`` heads hold whole
    GQA groups or lie in one (``hl % g == 0`` or ``g % hl == 0``); a
    rank's heads are ``r*hl:(r+1)*hl`` and its kv heads ``kv0:kv1``, those
    of their groups."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    m, r = tp.axis_size("model"), tp.axis_rank("model")
    g, hl = h // hkv, h // m
    core = h % m == 0 and (hl % g == 0 or g % hl == 0)
    kv0, kv1 = (r * hl // g, (r * hl + hl - 1) // g + 1) if core else (0, hkv)
    eps, theta = cfg.norm_eps, cfg.rope_theta
    # a decode step reads the cache at rest: split over 'model' by
    # head_dim (``hd``) even where the heads do not split
    decode = pos is not None or cross_cached
    hd = decode and tp.split(
        (cross_kv[0] if cross_cached else cache["k"]).shape[-1], dh)
    if not core and not hd:
        tp.replicated("attention core")

    # a split core's q columns are its heads (m divides h * dh)
    q = (column_dense(params["wq"], x, h * dh)[0] if core else
         whole_columns(params["wq"], x, h * dh)).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(_split_norm(params["q_norm"], core), q, eps)

    # the new k/v: this rank's kv heads (``own``) or every kv head
    own = cross_kv is None and core and hkv % m == 0
    if cross_kv is not None:
        k, v = cross_kv
    elif own:
        # this rank's k/v columns are its heads' kv heads
        q = apply_rope(q, positions, theta)
        k = column_dense(params["wk"], x, hkv * dh)[0].reshape(b, s, -1, dh)
        v = column_dense(params["wv"], x, hkv * dh)[0].reshape(b, s, -1, dh)
        if cfg.qk_norm:
            k = rmsnorm(_split_norm(params["k_norm"], True), k, eps)
        k = apply_rope(k, positions, theta)
    else:
        q = apply_rope(q, positions, theta)
        k = whole_columns(params["wk"], x, hkv * dh).reshape(b, s, hkv, dh)
        v = whole_columns(params["wv"], x, hkv * dh).reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            k = rmsnorm(params["k_norm"], k, eps)
        k = apply_rope(k, positions, theta)

    if decode:
        if cross_cached:
            ck, cv = cross_kv
        else:
            cache = _write_token(cache, _kv_at_rest(k, own, hd),
                                 _kv_at_rest(v, own, hd), pos)
            ck, cv = cache["k"], cache["v"]
        out = _decode_read(q, ck, cv, cfg, core, hd, kv0, kv1,
                           None if cross_cached else pos, window)
    else:
        if cache is not None:
            hd = tp.split(cache["k"].shape[-1], dh)
            cache = {"k": _write_prefill(cache["k"], _kv_at_rest(k, own, hd)),
                     "v": _write_prefill(cache["v"], _kv_at_rest(v, own, hd))}
        if not own:
            k, v = _kv_heads(k, v, core, kv0, kv1)
        if cross_kv is not None or bidirectional:
            out = _sdpa(q, k, v, cfg, torch.ones((s, k.shape[1]),
                                                 dtype=torch.bool,
                                                 device=x.device))
        elif cache is None and window > 0 and s % window == 0 and s > window:
            out = _local_attention(q, k, v, cfg, window)
        else:
            out = _sdpa(q, k, v, cfg, causal_mask(s, s, 0, window, x.device))

    out = out.reshape(b, s, -1)
    wo = params["wo"]
    if tp.split(wo["w"].shape[0], h * dh):
        y = tp.reduce_from((out if core else tp.split_to(out)) @ wo["w"])
        if "b" in wo:
            y = y + tp.shared(wo["b"])
    else:
        tp.replicated("attention o-proj")
        y = dense(wo, out)
    return y, cache


def _kv_heads(k, v, core: bool, kv0: int, kv1: int):
    """The kv heads ``kv0:kv1`` of replicated ``k``/``v`` where the core is
    split (through ``copy_to``: several ranks' heads may read one kv
    head), else ``k``/``v``."""
    if not core:
        return k, v
    return (tp.copy_to(k)[:, :, kv0:kv1], tp.copy_to(v)[:, :, kv0:kv1])


def _context_parallel() -> bool:
    """Whether the step's rules split the cache's sequence over a 'data'
    axis of more than one rank (``kv_seq``: long-context decode)."""
    return "data" in ctx.rule("kv_seq") and tp.axis_size("data") > 1


def kv_at_rest(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """New k or v of this rank's rows, every kv head in full head_dim, as
    a cache leaf like ``like`` holds them at rest (``_kv_at_rest``)."""
    return _kv_at_rest(t, False, tp.split(like.shape[-1], t.shape[-1]))


def _kv_at_rest(t, own: bool, hd: bool) -> torch.Tensor:
    """New k or v (B, S, kv heads, head_dim) as the cache holds them at
    rest (``sharding.rules.cache_spec``): every kv head, this rank's
    head_dim slice where 'model' splits head_dim (``hd``), the rows of
    every 'data' rank where the step split them.  ``t`` holds this rank's
    kv heads in full head_dim (``own``), which reach that layout by an
    all-to-all over 'model', or every kv head, sliced locally."""
    if hd:
        t = (tp.all_to_all(t, split_dim=-1, cat_dim=2) if own else
             tp.split_to(t, dim=-1))
    else:
        tp.replicated("kv cache")
        if own:
            t = tp.gather_from(t, dim=2)
    return tp.all_rows(t)


def _chunk(c: torch.Tensor) -> int:
    """The global position of this rank's first cache slot: its chunk of
    the sequence over 'data' under ``_context_parallel``, else 0."""
    return tp.axis_rank("data") * c.shape[1] if _context_parallel() else 0


def _write_prefill(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The prefill's ``t`` (B, S, ...) written at positions ``[0, S)`` of
    the cache leaf ``c``, this rank's chunk of it."""
    n, lo = c.shape[1], _chunk(c)
    hi = min(t.shape[1], lo + n)
    if hi <= lo:
        return c
    return torch.cat([t[:, lo:hi].to(c.dtype), c[:, hi - lo:]], 1)


def _write_token(cache: dict, k: torch.Tensor, v: torch.Tensor, pos) -> dict:
    """One token's k/v written at ``pos`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps): only by the rank whose chunk holds
    it."""
    ck, cv = cache["k"], cache["v"]
    n, lo = ck.shape[1], _chunk(ck)
    total = n * (tp.axis_size("data") if _context_parallel() else 1)
    kpos = lo + torch.arange(n, device=ck.device)
    at = (kpos == torch.clamp(pos, 0, total - 1))[None, :, None, None]
    return {"k": torch.where(at, k.to(ck.dtype), ck),
            "v": torch.where(at, v.to(cv.dtype), cv)}


def _decode_read(q, ck, cv, cfg, core: bool, hd: bool, kv0: int, kv1: int,
                 pos, window: int) -> torch.Tensor:
    """One query token against the cache leaves ``ck``/``cv`` at rest
    (this rank's chunk: keys up to ``pos``, within ``window``, by global
    position; every key for a cross-attention cache, ``pos`` None).
    Returns the attention's output in the o-proj's layout: this rank's
    heads where the core is split, else every head.

    Where 'model' splits head_dim (``hd``), every q head's head_dim slice
    is taken (an all-to-all over 'model' from a split core's heads, else a
    local slice), the scores are this slice's partial sums, added over
    'model' (``reduce_from``) before the fp32 softmax, and ``p @ v``
    gives every head's slice of the output, sent back to the heads' ranks
    by an all-to-all (or gathered over 'model' for a replicated o-proj
    input).  Else the rank's heads read their kv heads of the whole
    cache.  Where the step split the rows over 'data', the rank reads its
    rows of the cache."""
    b = q.shape[0]
    dh = cfg.resolved_head_dim
    if hd:
        q = (tp.all_to_all(q, split_dim=-1, cat_dim=2) if core else
             tp.split_to(q, dim=-1))
    elif core:
        ck, cv = ck[:, :, kv0:kv1], cv[:, :, kv0:kv1]
    ck, cv = tp.own_rows(ck), tp.own_rows(cv)
    n = ck.shape[1]
    kpos = _chunk(ck) + torch.arange(n, device=q.device)
    if pos is None:
        mask = torch.ones((1, n), dtype=torch.bool, device=q.device)
    else:
        mask = kpos <= pos
        if window > 0:
            mask = mask & (kpos > pos - window)
    out = _sdpa_cached(q, ck, cv, dh ** -0.5, mask.expand(b, 1, n), hd)
    if hd:
        out = (tp.all_to_all(out, split_dim=2, cat_dim=-1) if core else
               tp.gather_from(out, dim=-1))
    return out


def _sdpa_cached(q, k, v, scale: float, mask, hd: bool) -> torch.Tensor:
    """``_sdpa`` of one query token over a cache at rest: the scores'
    head_dim partial sums added over 'model' where it splits head_dim
    (``hd``); under ``_context_parallel`` each rank's chunk's maximum,
    sum of exponentials and weighted value sum, combined over 'data'
    flash-decoding style (the global maximum by an all-gather, the
    rescaled sums added by an all-reduce)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, h // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    if hd:
        scores = tp.reduce_from(scores)
    scores = torch.where(mask[:, None, None, :, :], scores * scale,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    if not _context_parallel():
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return out.reshape(b, sq, h, d)
    peak = tp.gather_from(scores.amax(-1, keepdim=True), "data", dim=-1)
    e = torch.exp(scores - peak.amax(-1, keepdim=True))
    num = torch.einsum("bkgqs,bskd->bqkgd", e, v.float())
    den = e.sum(-1).permute(0, 3, 1, 2)[..., None]          # (b, q, k, g, 1)
    both = tp.reduce_from(torch.cat([num, den], -1), "data")
    out = (both[..., :-1] / both[..., -1:]).to(v.dtype)
    return out.reshape(b, sq, h, d)


def attention(params, x: torch.Tensor, positions: torch.Tensor, cfg,
              window: int = 0, cache: Optional[dict] = None,
              pos: Optional[torch.Tensor] = None,
              cross_kv: Optional[tuple] = None, bidirectional: bool = False,
              cross_cached: bool = False):
    """Returns (y, new_cache).

    * full-sequence training pass: ``cache=None`` — the banded
      ``_local_attention`` when the window tiles the sequence (``s %
      window == 0 and s > window``), else causal (windowed) attention.
    * prefill: ``cache`` given, ``pos=None`` -> k/v fill its first S slots
      (the rest of the cache is kept), causal (windowed) attention.
    * decode: S == 1 and ``pos`` (a 0-dim integer tensor) given -> k/v
      written at ``pos`` (clamped into the cache, as
      ``dynamic_update_slice`` clamps), attention to positions ``<= pos``
      (within the window if any).
    * cross-attention: ``cross_kv = (k, v)`` precomputed from the
      encoder; the cache and positions are bypassed.
    * bidirectional (the encoder's): ``bidirectional=True``, no cache;
      every query sees every key.
    * ``cross_cached``: a decode step's ``cross_kv``, read from the cache
      as it holds them at rest (over a mesh: this rank's head_dim slice,
      its chunk of the sequence under ``kv_seq``, every row).
    """
    params = _whole_weights(params, x.shape[-1])
    if tp.axis_size("model") > 1 or (
            (cache is not None or cross_cached)
            and (tp.rows_split() or _context_parallel())):
        return _attention_split(params, x, positions, cfg, window, cache,
                                pos, cross_kv, bidirectional, cross_cached)
    b, s, _ = x.shape
    if cross_kv is not None:
        dh = cfg.resolved_head_dim
        q = dense(params["wq"], x).reshape(b, s, cfg.n_heads, dh)
        if cfg.qk_norm:
            q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k, v = cross_kv
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, cfg, mask)
        return dense(params["wo"], out.reshape(b, s, -1)), cache

    q, k, v = _qkv(params, x, cfg, positions)
    if bidirectional:
        out = _sdpa(q, k, v, cfg, torch.ones((s, s), dtype=torch.bool,
                                             device=x.device))
    elif cache is None:
        if window > 0 and s % window == 0 and s > window:
            out = _local_attention(q, k, v, cfg, window)
        else:
            out = _sdpa(q, k, v, cfg, causal_mask(s, s, 0, window, x.device))
    elif pos is None:
        ck, cv = cache["k"], cache["v"]
        cache = {"k": torch.cat([k.to(ck.dtype), ck[:, s:]], 1),
                 "v": torch.cat([v.to(cv.dtype), cv[:, s:]], 1)}
        out = _sdpa(q, k, v, cfg, causal_mask(s, s, 0, window, x.device))
    else:
        sk = cache["k"].shape[1]
        kpos = torch.arange(sk, device=x.device)
        at = (kpos == torch.clamp(pos, 0, sk - 1))[None, :, None, None]
        ck = torch.where(at, k.to(cache["k"].dtype), cache["k"])
        cv = torch.where(at, v.to(cache["v"].dtype), cache["v"])
        cache = {"k": ck, "v": cv}
        m = kpos <= pos
        if window > 0:
            m = m & (kpos > pos - window)
        out = _sdpa(q, ck, cv, cfg, m.expand(b, 1, sk))
    y = dense(params["wo"], out.reshape(b, s, -1))
    return y, cache


def cross_kv_from_encoder(params, enc_out: torch.Tensor, cfg):
    """Precompute cross-attention K/V from encoder outputs (no RoPE);
    over a mesh, whole (their 'model' columns gathered)."""
    b, s, _ = enc_out.shape
    dh = cfg.resolved_head_dim
    params = _whole_weights(params, enc_out.shape[-1])
    k = whole_columns(params["wk"], enc_out, cfg.n_kv_heads * dh).reshape(
        b, s, cfg.n_kv_heads, dh)
    v = whole_columns(params["wv"], enc_out, cfg.n_kv_heads * dh).reshape(
        b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v
