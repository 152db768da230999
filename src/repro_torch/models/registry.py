"""Uniform model API over all families (reference ``repro.models.registry``).

``bind(cfg)`` returns a ``ModelAPI`` whose methods take and return plain
trees of tensors:

  init(gen, dtype)                       -> params (on the generator's device)
  train_loss(params, batch)              -> (loss, aux_metrics)
  prefill(params, batch, cache)          -> (logits, cache)
  decode(params, tokens, pos, cache)     -> (logits, cache)
  init_cache(batch_size, max_len, dtype, device, ...) -> cache
  input_specs(shape, dtype, batch)       -> batch tree of ``meta`` tensors

Batch layout (per client, no client axis here — the step builders vmap):
  train  : {'tokens': (B,S_t) int, 'labels': (B,S) int,
            ['prefix' (B,P,d) | 'frames' (B,S_e,d)]}
  prefill: {'tokens': (B,S_t) int, ['prefix' | 'frames']}
  decode : tokens (B,1) int + pos, a 0-dim integer tensor

``dtype`` defaults to float32 everywhere, as in the reference; bf16 gives
the reference's reduced-precision params, caches and float inputs.
``input_specs`` gives the shapes and dtypes of a batch as tensors on the
``meta`` device (no storage), the port's form of ``jax.ShapeDtypeStruct``.
``remat`` (default True, as the reference's) recomputes the LM's periodic
blocks, or the encoder-decoder's decoder layers, in the backward of
``train_loss`` under ``remat_policy`` (``"full"`` or ``"dots"``,
``models.remat``), with the same numbers; the serving entry points do not
differentiate and are not affected.  The reference's ``unroll`` (a layer
scan's unrolling) has no counterpart: the port's layers run as a loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models.common import softmax_xent


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    input_specs: Callable


def meta_spec(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the ``meta`` device: a shape
    and dtype with no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _enc_dec_split(seq_len: int) -> tuple[int, int]:
    """Audio enc-dec: half the token budget to frames, half to text."""
    return seq_len // 2, seq_len - seq_len // 2


def bind(cfg: ModelConfig, moe_dense: bool = False, remat: bool = True,
         remat_policy: str = "full") -> ModelAPI:
    """The family's ``ModelAPI``.  An unknown ``remat_policy`` raises; the
    encoder-decoder takes ``remat`` only (its policy is ``"full"``), as
    the reference's."""
    remat_mod.check_policy(remat_policy)
    if cfg.enc_layers > 0:
        return _bind_encdec(cfg, remat)
    return _bind_lm(cfg, moe_dense, remat, remat_policy)


def _bind_lm(cfg: ModelConfig, moe_dense: bool, remat: bool,
             remat_policy: str) -> ModelAPI:
    def init(gen: torch.Generator, dtype=torch.float32):
        return lm_mod.init_lm(gen, cfg, dtype)

    def train_loss(params, batch):
        logits, aux = lm_mod.forward_train(params, batch["tokens"], cfg,
                                           prefix=batch.get("prefix"),
                                           remat=remat,
                                           remat_policy=remat_policy,
                                           moe_dense=moe_dense)
        loss = softmax_xent(logits, batch["labels"])
        return loss + aux, {"xent": loss, "aux": aux}

    def prefill(params, batch, cache):
        return lm_mod.forward_prefill(params, batch["tokens"], cfg, cache,
                                      prefix=batch.get("prefix"),
                                      moe_dense=moe_dense)

    def decode(params, tokens, pos, cache):
        return lm_mod.forward_decode(params, tokens, pos, cfg, cache,
                                     moe_dense=moe_dense)

    def init_cache(batch_size, max_len, dtype=torch.float32, device=None):
        return lm_mod.init_cache(cfg, batch_size, max_len, dtype, device)

    def input_specs(shape: InputShape, dtype=torch.float32,
                    batch: Optional[int] = None):
        b = batch if batch is not None else shape.global_batch
        s = shape.seq_len
        i32 = torch.int32
        if shape.mode in ("train", "prefill"):
            spec = {"tokens": meta_spec((b, s - cfg.prefix_len), i32)}
            if shape.mode == "train":
                spec["labels"] = meta_spec((b, s), i32)
            if cfg.prefix_len:
                spec["prefix"] = meta_spec(
                    (b, cfg.prefix_len, cfg.d_model), dtype)
            return spec
        return {"tokens": meta_spec((b, 1), i32), "pos": meta_spec((), i32)}

    return ModelAPI(cfg, init, train_loss, prefill, decode, init_cache,
                    input_specs)


def _bind_encdec(cfg: ModelConfig, remat: bool) -> ModelAPI:
    def init(gen: torch.Generator, dtype=torch.float32):
        return encdec_mod.init_encdec(gen, cfg, dtype)

    def train_loss(params, batch):
        logits, aux = encdec_mod.decode_train(params, batch["frames"],
                                              batch["tokens"], cfg,
                                              remat=remat)
        loss = softmax_xent(logits, batch["labels"])
        return loss + aux, {"xent": loss, "aux": aux}

    def prefill(params, batch, cache):
        return encdec_mod.prefill(params, batch["frames"], batch["tokens"],
                                  cfg, cache)

    def decode(params, tokens, pos, cache):
        return encdec_mod.decode_step(params, tokens, pos, cfg, cache)

    def init_cache(batch_size, max_len, dtype=torch.float32, device=None,
                   enc_len: int = 1024):
        return encdec_mod.init_encdec_cache(cfg, batch_size, max_len,
                                            enc_len, dtype, device)

    def input_specs(shape: InputShape, dtype=torch.float32,
                    batch: Optional[int] = None):
        b = batch if batch is not None else shape.global_batch
        i32 = torch.int32
        if shape.mode in ("train", "prefill"):
            enc_len, dec_len = _enc_dec_split(shape.seq_len)
            spec = {"frames": meta_spec((b, enc_len, cfg.d_model), dtype),
                    "tokens": meta_spec((b, dec_len), i32)}
            if shape.mode == "train":
                spec["labels"] = meta_spec((b, dec_len), i32)
            return spec
        return {"tokens": meta_spec((b, 1), i32), "pos": meta_spec((), i32)}

    return ModelAPI(cfg, init, train_loss, prefill, decode, init_cache,
                    input_specs)
