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

Over a mesh (a ``sharding.ctx.use_mesh_rules`` context: the weights are a
rank's local shards) ``attention`` gathers the weights' FSDP shards over
'data' and, where 'model' has more than one rank, runs
``_attention_split``: the core split over q heads where |model| divides
``n_heads`` (a rank takes its heads and the kv heads of their GQA groups;
the k/v columns are gathered over 'model' where their split cuts a kv
head), else the core replicated on gathered q/k/v; then the o-proj's row
slice and an all-reduce (``sharding.tp``).  The KV cache a meshed step
hands in is whole (``launch.steps.lower_serve``); the new tokens' k/v are
gathered over 'model' to write it.  On one card, and on a 1-rank 'model'
axis, the code below ``_attention_split`` runs unchanged.
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
from repro_torch.sharding import tp

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
                     bidirectional):
    """``attention`` with 'model' of size m > 1 (see the module's
    docstring).  Heads split where m divides ``n_heads`` and a rank's
    ``hl`` heads hold whole GQA groups or lie in one (``hl % g == 0`` or
    ``g % hl == 0``); a rank's heads are ``r*hl:(r+1)*hl`` and its kv heads
    ``kv0:kv1``, those of their groups."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    m, r = tp.axis_size("model"), tp.axis_rank("model")
    g, hl = h // hkv, h // m
    core = h % m == 0 and (hl % g == 0 or g % hl == 0)
    kv0, kv1 = (r * hl // g, (r * hl + hl - 1) // g + 1) if core else (0, hkv)
    eps, theta = cfg.norm_eps, cfg.rope_theta
    if not core:
        tp.replicated("attention core")

    # a split core's q columns are its heads (m divides h * dh)
    q = (column_dense(params["wq"], x, h * dh)[0] if core else
         whole_columns(params["wq"], x, h * dh)).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(_split_norm(params["q_norm"], core), q, eps)

    k_rep = v_rep = None
    if cross_kv is not None:
        k_rep, v_rep = cross_kv
    elif core and hkv % m == 0:
        # this rank's k/v columns are its heads' kv heads
        q = apply_rope(q, positions, theta)
        k = column_dense(params["wk"], x, hkv * dh)[0].reshape(b, s, -1, dh)
        v = column_dense(params["wv"], x, hkv * dh)[0].reshape(b, s, -1, dh)
        if cfg.qk_norm:
            k = rmsnorm(_split_norm(params["k_norm"], True), k, eps)
        k = apply_rope(k, positions, theta)
        if cache is not None:
            k_rep, v_rep = tp.gather_from(k, dim=2), tp.gather_from(v, dim=2)
    else:
        q = apply_rope(q, positions, theta)
        k = whole_columns(params["wk"], x, hkv * dh).reshape(b, s, hkv, dh)
        v = whole_columns(params["wv"], x, hkv * dh).reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            k = rmsnorm(params["k_norm"], k, eps)
        k_rep, v_rep = apply_rope(k, positions, theta), v
        k, v = _kv_heads(k_rep, v_rep, core, kv0, kv1)

    if cross_kv is not None:
        k, v = _kv_heads(k_rep, v_rep, core, kv0, kv1)
        out = _sdpa(q, k, v, cfg, torch.ones((s, k.shape[1]),
                                             dtype=torch.bool,
                                             device=x.device))
    elif cache is None:
        if bidirectional:
            out = _sdpa(q, k, v, cfg, torch.ones((s, s), dtype=torch.bool,
                                                 device=x.device))
        elif window > 0 and s % window == 0 and s > window:
            out = _local_attention(q, k, v, cfg, window)
        else:
            out = _sdpa(q, k, v, cfg, causal_mask(s, s, 0, window, x.device))
    elif pos is None:
        ck, cv = cache["k"], cache["v"]
        cache = {"k": torch.cat([k_rep.to(ck.dtype), ck[:, s:]], 1),
                 "v": torch.cat([v_rep.to(cv.dtype), cv[:, s:]], 1)}
        out = _sdpa(q, k, v, cfg, causal_mask(s, s, 0, window, x.device))
    else:
        sk = cache["k"].shape[1]
        kpos = torch.arange(sk, device=x.device)
        at = (kpos == torch.clamp(pos, 0, sk - 1))[None, :, None, None]
        ck = torch.where(at, k_rep.to(cache["k"].dtype), cache["k"])
        cv = torch.where(at, v_rep.to(cache["v"].dtype), cache["v"])
        cache = {"k": ck, "v": cv}
        mk = kpos <= pos
        if window > 0:
            mk = mk & (kpos > pos - window)
        out = _sdpa(q, ck[:, :, kv0:kv1], cv[:, :, kv0:kv1], cfg,
                    mk.expand(b, 1, sk))

    out = out.reshape(b, s, -1)
    wo = params["wo"]
    if tp.split(wo["w"].shape[0], h * dh):
        y = tp.reduce_from((out if core else tp.split_to(out)) @ wo["w"])
        if "b" in wo:
            y = y + wo["b"]
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


def attention(params, x: torch.Tensor, positions: torch.Tensor, cfg,
              window: int = 0, cache: Optional[dict] = None,
              pos: Optional[torch.Tensor] = None,
              cross_kv: Optional[tuple] = None, bidirectional: bool = False):
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
    """
    params = _whole_weights(params, x.shape[-1])
    if tp.axis_size("model") > 1:
        return _attention_split(params, x, positions, cfg, window, cache,
                                pos, cross_kv, bidirectional)
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
