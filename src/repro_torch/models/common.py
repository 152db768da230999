"""Shared model pieces: init, norms, RoPE, activations, dense and embedding
layers, GroupNorm, cross-entropy and accuracy (reference
``repro.models.common``).

Params are nested dicts of tensors, float32 unless an initializer is given
the reference's ``dtype`` (bf16 for the LM families' reduced-precision
path; ``DTypePolicy``).  Every initializer draws in float32 from an
explicit ``torch.Generator`` on the generator's own device (a CUDA
generator draws a billion weights in milliseconds) and casts to ``dtype``
after the scale, as the reference does.  Draws cannot replay the
reference's ``jax.random``: a run that must match it carries the
reference's params across as numpy arrays.  Norms, RoPE and the loss
compute in float32 and cast back to the input's dtype at the reference's
points.  Activations of the CNNs are NHWC tensors; those of the LMs are
``(B, S, d)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import tp

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, stddev, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, stddev²) drawn in float32 on the generator's device, cast to
    ``dtype``, then moved to ``device`` (default: left there)."""
    x = (torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=gen.device) * stddev).to(dtype)
    return x if device is None else x.to(device)


def lecun_init(gen: torch.Generator, shape, fan_in=None, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in); ``fan_in`` defaults to ``shape[0]``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal_init(gen, shape, 1.0 / np.sqrt(max(fan_in, 1)), device,
                       dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return normal_init(gen, shape, 1.0, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device, dtype=torch.float32) -> dict:
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}  # (1+scale)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with the ``(1 + scale)`` parameterization (over a
    mesh the scale ``sharding.tp.shared`` over 'data')."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + tp.shared(params["scale"]).float())).to(x.dtype)


def groupnorm_init(c: int, device="cpu", dtype=torch.float32) -> dict:
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates the
    two split halves of D (not interleaved pairs), angles in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions.float()[..., None] * freqs                # (..., S, D/2)
    ang = ang[..., None, :]                                   # over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(name: str):
    """``gelu`` is the tanh approximation, as the reference's
    ``jax.nn.gelu(approximate=True)``."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# Dense / embedding layers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               use_bias: bool = False, dtype=torch.float32) -> dict:
    p = {"w": lecun_init(gen, (d_in, d_out), dtype=dtype)}
    if use_bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``; over a mesh the caller gathers ``w``, and the bias
    is ``sharding.tp.shared`` over 'data'."""
    y = x @ params["w"]
    if "b" in params:
        y = y + tp.shared(params["b"])
    return y


def column_dense(params: dict, x: torch.Tensor, d_out: int):
    """``(y, split)``: a replicated ``x`` through a column weight of
    ``d_out`` columns.  Where a meshed step split the columns over 'model'
    (``split``), ``y`` is this rank's columns: ``x`` enters through
    ``sharding.tp.copy_to`` and the replicated bias through ``split_to``;
    else ``dense(params, x)``."""
    if not tp.split(params["w"].shape[-1], d_out):
        tp.replicated(f"{d_out}-column projection")
        return dense(params, x), False
    y = tp.copy_to(x) @ params["w"]
    if "b" in params:
        y = y + tp.split_to(tp.shared(params["b"]), dim=0)
    return y, True


def whole_columns(params: dict, x: torch.Tensor, d_out: int) -> torch.Tensor:
    """``column_dense``'s output whole: its 'model' columns gathered where
    they are split."""
    y, split = column_dense(params, x, d_out)
    return tp.gather_from(y) if split else y


def mlp_split(p: dict, x: torch.Tensor, act, d_ff: int, note: str):
    """``(p, y)``: the MLP weights ``p`` (``w_up``,
    ``w_down``, and ``w_gate`` where gated) whole over 'data' (FSDP shards
    the rows of ``w_up``/``w_gate`` and the columns of ``w_down``), and,
    where 'model' splits the ``d_ff`` hidden (the reference's
    ``constrain(h, (..., 'ffn'))``), the MLP's output: ``x`` through
    ``copy_to`` into the columns, the rows' partial sums all-reduced.
    ``y`` is None where the hidden is whole (``note`` names the op left
    replicated)."""
    d = x.shape[-1]
    p = {k: tp.whole(w, 1 if k == "w_down" else 0, d) for k, w in p.items()}
    if not tp.split(p["w_up"].shape[-1], d_ff):
        tp.replicated(note)
        return p, None
    x = tp.copy_to(x)
    h = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * h if "w_gate" in p else act(h)
    return p, tp.reduce_from(h @ p["w_down"])


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int,
                 d_model: int) -> torch.Tensor:
    """``table[ids]`` of a ``vocab`` x ``d_model`` table.  Over a mesh (the
    table a rank's shard), its FSDP columns are gathered over 'data'; a
    vocabulary split over 'model' is a masked lookup of this rank's rows
    (zero elsewhere) summed over 'model' by ``sharding.tp.reduce_from``:
    exactly one rank adds a non-zero row, so the sum is exact."""
    table = tp.whole(table, 1, d_model)
    if not tp.split(table.shape[0], vocab):
        tp.replicated("embedding")
        return table[ids.long()]
    n = table.shape[0]
    local = ids.long() - tp.axis_rank("model") * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.reduce_from(torch.where(mine[..., None], rows,
                                      torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device)))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with an fp32 logsumexp; labels < 0 are padding.
    Where a meshed step split the client's rows over 'data'
    (``sharding.tp.rows_split``), the mean over all of them: this rank's
    sum and count all-reduced over 'data' (``reduce_from``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    total, count = torch.sum((lse - ll) * valid), valid.sum()
    if tp.rows_split():
        total, count = tp.reduce_from(torch.stack([total, count]),
                                      "data").unbind(0)
    return total / torch.clamp_min(count, 1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of non-padding positions (labels >= 0) whose argmax is the
    label."""
    pred = torch.argmax(logits, dim=-1)
    valid = labels >= 0
    return (((pred == labels) & valid).sum()
            / torch.clamp_min(valid.sum(), 1))


@dataclasses.dataclass
class DTypePolicy:
    """Parameter and compute dtypes (reference ``models.common.
    DTypePolicy``): float32 by default; ``tpu()`` is the reference's bf16
    policy, which the port runs on the H100's tensor cores."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def tpu():
        return DTypePolicy(param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
