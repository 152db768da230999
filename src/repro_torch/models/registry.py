"""Uniform model API over all families (reference ``repro.models.registry``).

``bind(cfg)`` returns a ``ModelAPI`` whose methods take and return plain
trees of tensors:

  init(gen)                              -> params (on the generator's device)
  prefill(params, batch, cache)          -> (logits, cache)
  init_cache(batch_size, max_len, ...)   -> cache

Batch layout (per user, no user axis here — the serving engine vmaps):
  prefill: {'tokens': (B,S_t) int, ['prefix' (B,P,d) | 'frames' (B,S_e,d)]}

``train_loss``, ``decode`` and ``input_specs`` are the ``lm`` training
slice's (ROADMAP A12b) and raise until it lands.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    input_specs: Callable


def _a12b(what: str) -> Callable:
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"ModelAPI.{what} is not ported yet: it comes with the lm "
            "training slice (ROADMAP A12b)")
    return missing


def bind(cfg: ModelConfig) -> ModelAPI:
    if cfg.enc_layers > 0:
        return _bind_encdec(cfg)
    return _bind_lm(cfg)


def _bind_lm(cfg: ModelConfig) -> ModelAPI:
    def init(gen: torch.Generator):
        return lm_mod.init_lm(gen, cfg)

    def prefill(params, batch, cache):
        return lm_mod.forward_prefill(params, batch["tokens"], cfg, cache,
                                      prefix=batch.get("prefix"))

    def init_cache(batch_size, max_len, device=None):
        return lm_mod.init_cache(cfg, batch_size, max_len, device)

    return ModelAPI(cfg, init, _a12b("train_loss"), prefill, _a12b("decode"),
                    init_cache, _a12b("input_specs"))


def _bind_encdec(cfg: ModelConfig) -> ModelAPI:
    def init(gen: torch.Generator):
        return encdec_mod.init_encdec(gen, cfg)

    def prefill(params, batch, cache):
        return encdec_mod.prefill(params, batch["frames"], batch["tokens"],
                                  cfg, cache)

    def init_cache(batch_size, max_len, device=None, enc_len: int = 1024):
        return encdec_mod.init_encdec_cache(cfg, batch_size, max_len,
                                            enc_len, device)

    return ModelAPI(cfg, init, _a12b("train_loss"), prefill, _a12b("decode"),
                    init_cache, _a12b("input_specs"))
