"""Encoder-decoder transformer (seamless-m4t backbone) (reference
``repro.models.encdec``).

The encoder consumes *precomputed frame embeddings* (B, S_enc, d) — the
audio frontend (mel + conformer conv) is the allowed stub — and runs
bidirectional self-attention layers.  The decoder is a causal LM stack with
cross-attention into the encoder outputs.  Both stacks are stored with a
leading layer axis (``encoder``, ``decoder``), as the reference's, and run
as loops over it in order.

``decode_train`` is the teacher-forced training pass.  ``prefill``
computes the cross-attention K/V once and returns them in the cache beside
the self-attention KV cache; ``decode_step`` reads both and writes one
token's self-attention K/V at ``pos``.  Over a mesh the layers split as
``models.attention`` and ``models.lm``'s MLP and head do; the cross K/V
are whole in the training pass and the prefill, and the cache holds
them, as the self-attention's, at their placements.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    embed_init,
    embed_lookup,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.models import remat as remat_mod
from repro_torch.models.lm import _head, _mlp_apply, _mlp_init
from repro_torch.utils.tree import tree_index, tree_stack, tree_unstack

PyTree = Any


def _enc_layer_init(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev, dtype),
        "attn": attn_mod.attn_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dev, dtype),
        "mlp": _mlp_init(gen, cfg, cfg.d_ff, dtype),
    }


def _dec_layer_init(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev, dtype),
        "self_attn": attn_mod.attn_init(gen, cfg, dtype),
        "norm_x": rmsnorm_init(cfg.d_model, dev, dtype),
        "cross_attn": attn_mod.attn_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dev, dtype),
        "mlp": _mlp_init(gen, cfg, cfg.d_ff, dtype),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> PyTree:
    """Params of ``dtype`` on the generator's device."""
    enc = [_enc_layer_init(gen, cfg, dtype) for _ in range(cfg.enc_layers)]
    dec = [_dec_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    dev = gen.device
    return {
        "embed": {"table": embed_init(gen, (cfg.vocab, cfg.d_model), dtype)},
        "encoder": tree_stack(enc),
        "enc_norm": rmsnorm_init(cfg.d_model, dev, dtype),
        "decoder": tree_stack(dec),
        "final_norm": rmsnorm_init(cfg.d_model, dev, dtype),
    }


def _sinusoidal_pos(s: int, d: int, device=None) -> torch.Tensor:
    """Length-agnostic sinusoidal encoder positions, (s, d) float32, sines
    in the even columns and cosines in the odd ones."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    log_base = torch.log(torch.full((), 10000.0, device=device))
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-log_base / d))
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d + 1) // 2])
    return pe


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> (B, S_enc, d)."""
    b, s, _ = frames.shape
    dev = frames.device
    x = frames + _sinusoidal_pos(s, cfg.d_model, dev).to(frames.dtype)[None]
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    for p in tree_unstack(params["encoder"], cfg.enc_layers):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, _ = attn_mod.attention(p["attn"], h, positions, cfg,
                                  bidirectional=True)
        x = x + y
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + _mlp_apply(p["mlp"], h, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(p, x, cfg, positions, cross_kv, cache=None, pos=None):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn_mod.attention(p["self_attn"], h, positions, cfg,
                                  cache=cache, pos=pos)
    x = x + y
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
    y, _ = attn_mod.attention(p["cross_attn"], h, positions, cfg,
                              cross_kv=cross_kv, cross_cached=pos is not None)
    x = x + y
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    x = x + _mlp_apply(p["mlp"], h, cfg)
    return x, cache


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype=torch.float32,
                      device=None) -> PyTree:
    dh = cfg.resolved_head_dim
    n = cfg.n_layers
    cross = (n, batch, enc_len, cfg.n_kv_heads, dh)
    return {"self": tree_stack([attn_mod.init_kv_cache(cfg, batch, max_len,
                                                       dtype, device)
                                for _ in range(n)]),
            "cross": {"k": torch.zeros(cross, dtype=dtype, device=device),
                      "v": torch.zeros(cross, dtype=dtype, device=device)}}


def decode_train(params, frames, tokens, cfg: ModelConfig,
                 remat: bool = True):
    """Teacher-forced training pass.  Returns (logits (B, S, V), aux=0).
    ``remat`` recomputes each decoder layer, its cross K/V projection
    included, in the backward (``models.remat``, ``"full"``); the encoder
    output is an input of each, and gets its gradient."""
    enc_out = encode(params, frames, cfg)
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab,
                     cfg.d_model)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    def layer(x, enc_out, positions, p):
        kv = attn_mod.cross_kv_from_encoder(p["cross_attn"], enc_out, cfg)
        return _dec_layer(p, x, cfg, positions, kv)[:1]

    for p in tree_unstack(params["decoder"], cfg.n_layers):
        # each layer reads the encoder output through a node of its own,
        # so its k and v gradients are summed before the sum over layers
        # with or without remat (the recompute's pullback sums them so)
        args = (x, enc_out.view_as(enc_out), positions, p)
        x, = (remat_mod.checkpoint(layer, args) if remat else layer(*args))
    return (_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(params, frames, tokens, cfg: ModelConfig, cache):
    """Encode + teacher-forced decoder prefill; fills self+cross caches.
    Returns (last-position logits (B, 1, V), cache)."""
    enc_out = encode(params, frames, cfg)
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab,
                     cfg.d_model)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    self_c, cross_c = [], []
    for i in range(cfg.n_layers):
        p = tree_index(params["decoder"], i)
        kv = attn_mod.cross_kv_from_encoder(p["cross_attn"], enc_out, cfg)
        x, c = _dec_layer(p, x, cfg, positions, kv,
                          cache=tree_index(cache["self"], i))
        self_c.append(c)
        like = cache["cross"]["k"]
        cross_c.append({"k": attn_mod.kv_at_rest(kv[0], like),
                        "v": attn_mod.kv_at_rest(kv[1], like)})
    logits = _head(params, x[:, -1:, :], cfg)
    return logits, {"self": tree_stack(self_c), "cross": tree_stack(cross_c)}


def decode_step(params, tokens, pos, cfg: ModelConfig, cache):
    """One-token decode using the cached self K/V and cross K/V.  tokens:
    (B, 1); pos: 0-dim integer tensor.  Returns (logits (B, 1, V),
    cache)."""
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab,
                     cfg.d_model)
    b = x.shape[0]
    positions = pos.reshape(1, 1).expand(b, 1)
    self_c = []
    for i in range(cfg.n_layers):
        p = tree_index(params["decoder"], i)
        c_cross = tree_index(cache["cross"], i)
        x, c = _dec_layer(p, x, cfg, positions,
                          (c_cross["k"], c_cross["v"]),
                          cache=tree_index(cache["self"], i), pos=pos)
        self_c.append(c)
    return (_head(params, x, cfg),
            {"self": tree_stack(self_c), "cross": cache["cross"]})
