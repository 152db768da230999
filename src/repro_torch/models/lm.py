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

``forward_prefill`` is the serving path: the full prompt writes the KV/SSM
caches and the head runs on the last position only.  ``forward_train``
and ``forward_decode`` come with the ``lm`` training slice (ROADMAP A12b).

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    activation,
    dense,
    embed_init,
    embed_lookup,
    lecun_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.utils.tree import tree_index, tree_stack

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


def _mlp_init(gen, cfg, d_ff):
    if cfg.mlp_gated:
        return {
            "w_gate": lecun_init(gen, (cfg.d_model, d_ff)),
            "w_up": lecun_init(gen, (cfg.d_model, d_ff)),
            "w_down": lecun_init(gen, (d_ff, cfg.d_model), fan_in=d_ff),
        }
    return {
        "w_up": lecun_init(gen, (cfg.d_model, d_ff)),
        "w_down": lecun_init(gen, (d_ff, cfg.d_model), fan_in=d_ff),
    }


def _mlp_apply(p, x, cfg):
    act = activation(cfg.act)
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


def layer_init(gen: torch.Generator, cfg: ModelConfig, sub: SubLayer) -> dict:
    dev = gen.device
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, dev)}
    if sub.kind == "attn":
        p["attn"] = attn_mod.attn_init(gen, cfg)
    else:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
    if sub.ffn == "mlp":
        d_ff = sub.d_ff_override or cfg.d_ff
        p["norm2"] = rmsnorm_init(cfg.d_model, dev)
        p["mlp"] = _mlp_init(gen, cfg, d_ff)
    elif sub.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dev)
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe)
    return p


def layer_cache_init(cfg: ModelConfig, sub: SubLayer, batch: int,
                     max_len: int, device=None):
    if sub.kind == "attn":
        return attn_mod.init_kv_cache(cfg, batch, max_len, device)
    return ssm_mod.init_ssm_cache(cfg, batch, device)


def layer_apply(p, x, sub: SubLayer, cfg: ModelConfig, positions, cache):
    """Pre-norm residual layer (prefill).  Returns (x, cache_out, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if sub.kind == "attn":
        y, cache = attn_mod.attention(p["attn"], h, positions, cfg,
                                      window=sub.window, cache=cache)
    else:
        y, cache = ssm_mod.ssm_apply(p["ssm"], h, cfg, cache=cache)
    x = x + y
    if sub.ffn == "mlp":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + _mlp_apply(p["mlp"], h, cfg)
    elif sub.ffn == "moe":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, a = moe_mod.moe_apply(p["moe"], h, cfg.moe, cfg.act)
        x = x + y
        aux = aux + a
    return x, cache, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Float32 params on the generator's device, drawn in the reference's
    key order (embedding, prelude, blocks period-major, tail, head)."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    params: dict = {
        "embed": {"table": embed_init(gen, (cfg.vocab, cfg.d_model))}}
    if prelude:
        params["prelude"] = {str(i): layer_init(gen, cfg, kinds[i])
                             for i in prelude}
    if n_blocks > 0:
        start = len(prelude)
        params["blocks"] = {
            f"p{j}": tree_stack([
                layer_init(gen, cfg, kinds[start + b * period + j])
                for b in range(n_blocks)])
            for j in range(period)}
    if tail:
        params["tail"] = {str(i): layer_init(gen, cfg, kinds[i]) for i in tail}
    params["final_norm"] = rmsnorm_init(cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": lecun_init(gen, (cfg.d_model, cfg.vocab))}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> PyTree:
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    cache: dict = {}
    if prelude:
        cache["prelude"] = {
            str(i): layer_cache_init(cfg, kinds[i], batch, max_len, device)
            for i in prelude}
    if n_blocks > 0:
        start = len(prelude)
        cache["blocks"] = {
            f"p{j}": tree_stack([
                layer_cache_init(cfg, kinds[start + b * period + j], batch,
                                 max_len, device)
                for b in range(n_blocks)])
            for j in range(period)}
    if tail:
        cache["tail"] = {
            str(i): layer_cache_init(cfg, kinds[i], batch, max_len, device)
            for i in tail}
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg, prefix=None):
    x = embed_lookup(params["embed"]["table"], tokens)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def _head(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = dense(params["head"], x)
    if cfg.logit_softcap > 0:
        lf = logits.float()
        logits = (torch.tanh(lf / cfg.logit_softcap)
                  * cfg.logit_softcap).to(logits.dtype)
    return logits


def forward_prefill(params, tokens, cfg: ModelConfig, cache, prefix=None):
    """Full-sequence forward writing caches.  tokens: (B, S_text); prefix:
    optional (B, P, d).  Returns (last-position logits (B, 1, V), cache)."""
    prelude, period, n_blocks, tail, kinds = layer_plan(cfg)
    x = _embed(params, tokens, cfg, prefix)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    new_cache: dict = {k: {} for k in cache}

    for i in prelude:
        x, c, _ = layer_apply(params["prelude"][str(i)], x, kinds[i], cfg,
                              positions, cache["prelude"][str(i)])
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
                                      block_cache[f"p{j}"])
                out[f"p{j}"] = c
            outs.append(out)
        new_cache["blocks"] = tree_stack(outs)

    for i in tail:
        x, c, _ = layer_apply(params["tail"][str(i)], x, kinds[i], cfg,
                              positions, cache["tail"][str(i)])
        new_cache["tail"][str(i)] = c

    logits = _head(params, x[:, -1:, :], cfg)
    return logits, new_cache
