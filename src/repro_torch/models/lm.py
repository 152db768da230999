"""Decoder-only LM stack covering dense / MoE / SSM / hybrid / VLM families
(reference ``repro.models.lm``).

Layers are grouped into repeating *period blocks* (period = lcm of the
local/global, MoE and hybrid interleave periods).  The state layout is the
reference's, since ERK budgets, masks and codec frames are defined over
it: the periodic body is stacked as ``blocks/p{j}`` with a leading
``n_blocks`` axis, layers outside it (a special first layer, a
non-divisible tail) are ``prelude/<i>`` and ``tail/<i>``, and the head is
the tied ``embed/table`` or ``head/w``.  The reference's ``lax.scan`` over
blocks is a loop over the leading axis, in order.

Modes:
  * ``forward_train``   — full sequence, returns (logits, aux_loss)
  * ``forward_prefill`` — full sequence, writes KV/SSM caches, head on the
    last position only (the serving path)
  * ``forward_decode``  — one token at position ``pos`` with caches

``forward_train`` unbinds each stacked block leaf once (``tree_unstack``),
so the backward stacks the per-block gradients into one tensor (indexing
``leaf[i]`` per block would make a full-size zero gradient per block).
Under ``remat`` (the default, as the reference's) each periodic block
runs through ``models.remat.checkpoint``, the port's ``jax.checkpoint``
of the reference's scan body: the backward recomputes the block from its
input (``"full"``) or from its input and its matmul outputs
(``"dots"``), with the same numbers.

VLM variants accept ``prefix`` — precomputed patch embeddings (B, P, d)
occupying the first P positions (the allowed frontend stub).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, SubLayer, layer_kinds
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    activation,
    embed_init,
    embed_lookup,
    lecun_init,
    mlp_split,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.sharding import tp
from repro_torch.utils.tree import tree_index, tree_stack, tree_unstack

PyTree = Any


# ---------------------------------------------------------------------------
# Structure resolution
# ---------------------------------------------------------------------------


def intrinsic_period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.local_period > 0:
        p = math.lcm(p, cfg.local_period)
    if cfg.moe is not None and cfg.moe_period > 1:
        p = math.lcm(p, cfg.moe_period)
    if cfg.ssm is not None and cfg.attn_period > 0:
        p = math.lcm(p, cfg.attn_period)
    return p


def layer_plan(cfg: ModelConfig):
    """Returns (prelude_idx, period, n_blocks, tail_idx, kinds)."""
    kinds = layer_kinds(cfg)
    prelude = [0] if cfg.dense_ff_first > 0 else []
    start = len(prelude)
    period = intrinsic_period(cfg)
    body = cfg.n_layers - start
    n_blocks = body // period
    tail_start = start + n_blocks * period
    tail = list(range(tail_start, cfg.n_layers))
    return prelude, period, n_blocks, tail, kinds


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def _mlp_init(gen, cfg, d_ff, dtype=torch.float32):
    if cfg.mlp_gated:
        return {
            "w_gate": lecun_init(gen, (cfg.d_model, d_ff), dtype=dtype),
            "w_up": lecun_init(gen, (cfg.d_model, d_ff), dtype=dtype),
            "w_down": lecun_init(gen, (d_ff, cfg.d_model), fan_in=d_ff,
                                 dtype=dtype),
        }
    return {
        "w_up": lecun_init(gen, (cfg.d_model, d_ff), dtype=dtype),
        "w_down": lecun_init(gen, (d_ff, cfg.d_model), fan_in=d_ff,
                             dtype=dtype),
    }


def _mlp_apply(p, x, cfg, d_ff=None):
    """The MLP of ``d_ff`` hidden units (default ``cfg.d_ff``); over a
    mesh split as ``common.mlp_split`` says."""
    act = activation(cfg.act)
    p, y = mlp_split(p, x, act, d_ff or cfg.d_ff, "mlp")
    if y is not None:
        return y
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


def layer_init(gen: torch.Generator, cfg: ModelConfig, sub: SubLayer,
               dtype=torch.float32) -> dict:
    dev = gen.device
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, dev, dtype)}
    if sub.kind == "attn":
        p["attn"] = attn_mod.attn_init(gen, cfg, dtype)
    else:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype)
    if sub.ffn == "mlp":
        d_ff = sub.d_ff_override or cfg.d_ff
        p["norm2"] = rmsnorm_init(cfg.d_model, dev, dtype)
        p["mlp"] = _mlp_init(gen, cfg, d_ff, dtype)
    elif sub.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dev, dtype)
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe, dtype)
    return p


def layer_cache_init(cfg: ModelConfig, sub: SubLayer, batch: int,
                     max_len: int, dtype=torch.float32, device=None):
    if sub.kind == "attn":
        return attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device)
    return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)


def layer_apply(p, x, sub: SubLayer, cfg: ModelConfig, positions,
                cache=None, pos=None, moe_dense: bool = False):
    """Pre-norm residual layer.  Returns (x, cache_out, aux).  No cache:
    training; a cache and no ``pos``: prefill; both: one-token decode."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if sub.kind == "attn":
        y, cache = attn_mod.attention(p["attn"], h, positions, cfg,
                                      window=sub.window, cache=cache, pos=pos)
    elif pos is None:
        y, cache = ssm_mod.ssm_apply(p["ssm"], h, cfg, cache=cache)
    else:
        y, cache = ssm_mod.ssm_decode_step(p["ssm"], h, cfg, cache)
    x = x + y
    if sub.ffn == "mlp":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + _mlp_apply(p["mlp"], h, cfg, sub.d_ff_override or cfg.d_ff)
    elif sub.ffn == "moe":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        moe_fn = moe_mod.moe_dense_ref if moe_dense else moe_mod.moe_apply
        y, a = moe_fn(p["moe"], h, cfg.moe, cfg.act)
        x = x + y
        aux = aux + a
    return x, cache, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig,
            dtype=torch.float32) -> PyTree:
    """Params of ``dtype`` on the generator's device (the MoE router, the
    SSM's ``A_log``/``D``/``dt_bias`` float32 always), drawn in the
    reference's key order (embedding, prelude, blocks period-major, tail,
    head)."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    params: dict = {
        "embed": {"table": embed_init(gen, (cfg.vocab, cfg.d_model), dtype)}}
    if prelude:
        params["prelude"] = {str(i): layer_init(gen, cfg, kinds[i], dtype)
                             for i in prelude}
    if n_blocks > 0:
        start = len(prelude)
        params["blocks"] = {
            f"p{j}": tree_stack([
                layer_init(gen, cfg, kinds[start + b * period + j], dtype)
                for b in range(n_blocks)])
            for j in range(period)}
    if tail:
        params["tail"] = {str(i): layer_init(gen, cfg, kinds[i], dtype)
                          for i in tail}
    params["final_norm"] = rmsnorm_init(cfg.d_model, gen.device, dtype)
    if not cfg.tie_embeddings:
        params["head"] = {"w": lecun_init(gen, (cfg.d_model, cfg.vocab),
                                          dtype=dtype)}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> PyTree:
    """Zero caches: KV and conv tails of ``dtype``, SSD states float32."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)

    def one(i):
        return layer_cache_init(cfg, kinds[i], batch, max_len, dtype, device)

    cache: dict = {}
    if prelude:
        cache["prelude"] = {str(i): one(i) for i in prelude}
    if n_blocks > 0:
        start = len(prelude)
        cache["blocks"] = {
            f"p{j}": tree_stack([one(start + b * period + j)
                                 for b in range(n_blocks)])
            for j in range(period)}
    if tail:
        cache["tail"] = {str(i): one(i) for i in tail}
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg, prefix=None):
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab, cfg.d_model)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def _logits(params, x, cfg):
    """Whole logits: ``x`` through the tied table or the untied
    ``head/w``.  Over a mesh a vocabulary split over 'model' (the tied
    table's rows) gives each rank its logits' columns, gathered over
    'model'; the untied ``head/w``'s rows (``d_model``) split over 'model'
    take this rank's slice of ``x`` and all-reduce the partial logits.
    FSDP shards are gathered over 'data' first."""
    d, v = cfg.d_model, cfg.vocab
    if cfg.tie_embeddings:
        table = tp.whole(params["embed"]["table"], 1, d)
        if tp.split(table.shape[0], v):
            return tp.gather_from(tp.copy_to(x) @ table.T)
        tp.replicated("logits")
        return x @ table.T
    w = tp.whole(params["head"]["w"], 1, v)
    if tp.split(w.shape[0], d):
        return tp.reduce_from(tp.split_to(x) @ w)
    tp.replicated("logits")
    return x @ w


def _head(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg)
    if cfg.logit_softcap > 0:
        lf = logits.float()
        logits = (torch.tanh(lf / cfg.logit_softcap)
                  * cfg.logit_softcap).to(logits.dtype)
    return logits


def forward_train(params, tokens, cfg: ModelConfig, prefix=None,
                  remat: bool = True, remat_policy: str = "full",
                  moe_dense: bool = False):
    """tokens: (B, S_text); prefix: optional (B, P, d).  Returns
    (logits (B, S_total, V), aux_loss scalar).  ``remat`` recomputes each
    periodic block in the backward under ``remat_policy``
    (``models.remat``); the prelude, the tail, the embedding and the head
    keep their activations, as in the reference."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    x = _embed(params, tokens, cfg, prefix)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for i in prelude:
        x, _, a = layer_apply(params["prelude"][str(i)], x, kinds[i], cfg,
                              positions, moe_dense=moe_dense)
        aux_total = aux_total + a

    if n_blocks > 0:
        start = len(prelude)

        def block_fn(x, positions, block_params):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for j in range(period):
                x, _, a = layer_apply(block_params[f"p{j}"], x,
                                      kinds[start + j], cfg, positions,
                                      moe_dense=moe_dense)
                aux = aux + a
            return x, aux

        auxs = []
        for block_params in tree_unstack(params["blocks"], n_blocks):
            if remat:
                x, aux = remat_mod.checkpoint(
                    block_fn, (x, positions, block_params), remat_policy)
            else:
                x, aux = block_fn(x, positions, block_params)
            auxs.append(aux)
        aux_total = aux_total + torch.sum(torch.stack(auxs))

    for i in tail:
        x, _, a = layer_apply(params["tail"][str(i)], x, kinds[i], cfg,
                              positions, moe_dense=moe_dense)
        aux_total = aux_total + a

    return _head(params, x, cfg), aux_total


def _run_cached(params, x, cfg: ModelConfig, cache, positions, pos=None,
                moe_dense: bool = False):
    """Every layer in order with its cache (prefill: ``pos=None``; decode:
    ``pos`` given).  Returns (x, new cache)."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    new_cache: dict = {k: {} for k in cache}

    for i in prelude:
        x, c, _ = layer_apply(params["prelude"][str(i)], x, kinds[i], cfg,
                              positions, cache["prelude"][str(i)], pos,
                              moe_dense)
        new_cache["prelude"][str(i)] = c

    if n_blocks > 0:
        start = len(prelude)
        outs: list[dict] = []
        for blk in range(n_blocks):
            block_params = tree_index(params["blocks"], blk)
            block_cache = tree_index(cache["blocks"], blk)
            out = {}
            for j in range(period):
                x, c, _ = layer_apply(block_params[f"p{j}"], x,
                                      kinds[start + j], cfg, positions,
                                      block_cache[f"p{j}"], pos, moe_dense)
                out[f"p{j}"] = c
            outs.append(out)
        new_cache["blocks"] = tree_stack(outs)

    for i in tail:
        x, c, _ = layer_apply(params["tail"][str(i)], x, kinds[i], cfg,
                              positions, cache["tail"][str(i)], pos,
                              moe_dense)
        new_cache["tail"][str(i)] = c
    return x, new_cache


def forward_prefill(params, tokens, cfg: ModelConfig, cache, prefix=None,
                    moe_dense: bool = False):
    """Full-sequence forward writing caches.  tokens: (B, S_text); prefix:
    optional (B, P, d).  Returns (last-position logits (B, 1, V), cache)."""
    x = _embed(params, tokens, cfg, prefix)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, new_cache = _run_cached(params, x, cfg, cache, positions,
                               moe_dense=moe_dense)
    return _head(params, x[:, -1:, :], cfg), new_cache


def forward_decode(params, tokens, pos, cfg: ModelConfig, cache,
                   moe_dense: bool = False):
    """One-token decode.  tokens: (B, 1); pos: 0-dim integer tensor (the
    write position, == number of tokens already in the cache).  Returns
    (logits (B, 1, V), cache)."""
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab,
                     cfg.d_model)
    b = x.shape[0]
    positions = pos.reshape(1, 1).expand(b, 1)
    x, new_cache = _run_cached(params, x, cfg, cache, positions, pos,
                               moe_dense)
    return _head(params, x, cfg), new_cache
