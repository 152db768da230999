"""Shared model pieces: init, GroupNorm, cross-entropy (reference
``repro.models.common``).  Activations are NHWC tensors."""
from __future__ import annotations

import numpy as np
import torch


def lecun_init(gen: torch.Generator, shape, fan_in=None,
               device="cpu") -> torch.Tensor:
    """N(0, 1/fan_in) float32, drawn on the generator's device (the CPU)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * std).to(device)


def groupnorm_init(c: int, device="cpu") -> dict:
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def groupnorm(params: dict, x: torch.Tensor, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: g = min(groups, c), decremented until it divides
    c; biased variance; eps inside the rsqrt."""
    n, h, w, c = x.shape
    g = min(groups, c)
    while c % g != 0:
        g -= 1
    xf = x.float().reshape(n, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * params["scale"].float() + params["bias"].float()).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with an fp32 logsumexp; labels < 0 are padding."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - ll) * valid) / torch.clamp_min(valid.sum(), 1.0)
