"""Mamba-2 blocks via the SSD (state-space duality) chunked algorithm
(reference ``repro.models.ssm``).

The full Mamba-2 mixer (arXiv:2405.21060): fused in-projection (z, x, B,
C, dt), depthwise causal conv over (x, B, C), softplus dt with bias,
scalar-per-head A, chunked SSD scan, D skip, gated RMSNorm, output
projection.  Single dispatch group (G=1), heads H = d_inner / head_dim.

``ssm_apply`` is the full-sequence block (training, and prefill with the
final SSD state and conv tail as its cache); ``ssm_decode_step`` is the
O(1)-per-token recurrent update of those two states.  The inter-chunk
recurrence is a loop in chunk order that keeps the state *before* each
chunk, as the reference's ``lax.scan`` emits it.  Softplus is the reference's
``logaddexp(x, 0)`` (``F.softplus`` turns into the identity above its
threshold).  The three-operand einsums are contracted pairwise, each in
the order stated at its line.

Over a mesh (``sharding.ctx.use_mesh_rules``; the weights a rank's
shards) ``in_proj``'s FSDP rows and ``out_proj``'s FSDP columns are
gathered over 'data'.  Where 'model' splits them: ``in_proj``'s columns
(split evenly across the z/x/B/C/dt segments) give this rank's part of
the projection, gathered over 'model' before ``_split_proj``; the
depthwise conv runs on this rank's ``conv_w`` channels and is gathered;
the scan runs on this rank's heads where |model| divides them (the
reference's ``constrain(xh, (..., 'heads', ...))``), B and C through
``copy_to``, and its output is gathered for the gated norm; then
``out_proj``'s row slice and an all-reduce (``sharding.tp``).  The cache
stays at its placements (``sharding.rules.cache_spec``): the prefill
keeps this rank's heads' final state and its channels' tail, and the
decode step updates them in place of a whole state.  Where the step split
the rows over 'data' (FSDP2D) a rank computes its rows and gathers every
row's new state over 'data' into its cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import lecun_init, rmsnorm_init
from repro_torch.sharding import tp


def _dims(cfg):
    spec = cfg.ssm
    d_inner = spec.expand * cfg.d_model
    n_heads = d_inner // spec.head_dim
    conv_dim = d_inner + 2 * spec.d_state
    return spec, d_inner, n_heads, conv_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_init(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """``A_log``, ``D`` and ``dt_bias`` stay float32 whatever ``dtype`` is,
    as in the reference."""
    spec, d_inner, n_heads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * spec.d_state + n_heads
    dev = gen.device
    in_proj = lecun_init(gen, (cfg.d_model, d_in_proj), dtype=dtype)
    conv_w = torch.randn((spec.conv_width, conv_dim), generator=gen,
                         dtype=torch.float32, device=dev)
    conv_w = (conv_w * spec.conv_width ** -0.5).to(dtype)
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
    u = torch.rand(n_heads, generator=gen, dtype=torch.float32, device=dev)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "D": torch.ones(n_heads, device=dev),
        "dt_bias": dt_bias,
        "norm": rmsnorm_init(d_inner, dev, dtype),
        "out_proj": lecun_init(gen, (d_inner, cfg.d_model), fan_in=d_inner,
                               dtype=dtype),
    }


def init_ssm_cache(cfg, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    """The SSD state is float32 whatever ``dtype`` is; the conv tail takes
    ``dtype`` (as the reference's)."""
    spec, d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "ssm_state": torch.zeros((batch, n_heads, spec.head_dim, spec.d_state),
                                 dtype=torch.float32, device=device),
        "conv_state": torch.zeros((batch, spec.conv_width - 1, conv_dim),
                                  dtype=dtype, device=device),
    }


def _gated_norm(norm_params, y, z, eps):
    yf = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    out = yf * torch.rsqrt(var + eps)
    return out * (1.0 + tp.shared(norm_params["scale"]).float())


def _split_proj(cfg, zxbcdt):
    spec, d_inner, n_heads, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * spec.d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _conv_full(params, xbc):
    """Depthwise causal conv over (B, L, C_conv)."""
    w = params["conv_w"].float()  # (W, C)
    width = w.shape[0]
    xf = xbc.float()
    pad = F.pad(xf, (0, 0, width - 1, 0))
    out = torch.zeros_like(xf)
    for i in range(width):
        out = out + pad[:, i: i + xf.shape[1], :] * w[i]
    out = out + params["conv_b"].float()
    return F.silu(out).to(xbc.dtype)


def _segsum(dA):
    """dA: (..., Q) log-decays -> (..., Q, Q) lower-tri cumulative sums,
    -inf above the diagonal (so exp gives exact zeros there)."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, torch.full((), -math.inf, device=dA.device))


def _ssd_chunked(xh, dt, a, Bm, Cm, chunk):
    """SSD over chunks.

    xh: (B, L, H, P)   inputs per head
    dt: (B, L, H)      softplus'd step sizes
    a:  (H,)           -exp(A_log), negative
    Bm, Cm: (B, L, N)  shared across heads (G=1)
    Returns y: (B, L, H, P) and final state (B, H, P, N).
    """
    b, l, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    nc = l // q
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")

    xh = (xh * dt[..., None]).reshape(b, nc, q, h, p).float()
    dA = (dt * a).reshape(b, nc, q, h)          # (B,C,Q,H) log decay
    dA = torch.movedim(dA, -1, 2)               # (B,C,H,Q)
    Bc = Bm.reshape(b, nc, q, n).float()
    Cc = Cm.reshape(b, nc, q, n).float()

    # -- intra-chunk (diagonal blocks): (scores ⊙ L) first, then with xh
    L = torch.exp(_segsum(dA))                  # (B,C,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,C,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * L, xh)

    # -- chunk states (right factors): (decay ⊙ xh) first, then with B
    cum = torch.cumsum(dA, dim=-1)              # (B,C,H,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B,C,H,Q)
    x_dec = xh * torch.movedim(decay_to_end, 2, 3)[..., None]  # (B,C,Q,H,P)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, x_dec)

    # -- inter-chunk recurrence, state BEFORE each chunk kept
    chunk_decay = torch.exp(cum[..., -1])       # (B,C,H)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)          # (B,C,H,P,N)

    # -- contribution of carried-in states: (C with state) first, then decay
    decay_in = torch.exp(cum)                   # (B,C,H,Q)
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, prev_states)
             * torch.movedim(decay_in, 2, 3)[..., None])

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry


def _proj_in(params, x, cfg):
    """``x @ in_proj``, whole; over a mesh the weight's FSDP rows are
    gathered over 'data' and its 'model' columns' outputs over 'model'."""
    spec, d_inner, n_heads, _ = _dims(cfg)
    w = tp.whole(params["in_proj"], 0, x.shape[-1])
    if tp.split(w.shape[-1], 2 * d_inner + 2 * spec.d_state + n_heads):
        return tp.gather_from(tp.copy_to(x) @ w)
    tp.replicated("ssm in_proj")
    return x @ w


def _conv_params(params, cfg):
    """``(conv params, split)``: the conv over this rank's channels where
    'model' splits ``conv_w``'s (the replicated bias sliced by
    ``split_to``), else the whole conv."""
    _, _, _, conv_dim = _dims(cfg)
    conv = {"conv_w": tp.shared(params["conv_w"]),
            "conv_b": tp.shared(params["conv_b"])}
    if not tp.split(params["conv_w"].shape[-1], conv_dim):
        tp.replicated("ssm conv")
        return conv, False
    return {**conv, "conv_b": tp.split_to(conv["conv_b"], dim=0)}, True


def _heads_split(cfg) -> bool:
    _, _, n_heads, _ = _dims(cfg)
    m = tp.axis_size("model")
    if m > 1 and n_heads % m:
        tp.replicated("ssm scan")
    return m > 1 and n_heads % m == 0


def _proj_out(params, y, x_dtype, cfg):
    """``y @ out_proj``; over a mesh the weight's FSDP columns are gathered
    over 'data', and 'model'-split rows take this rank's slice of ``y``
    and all-reduce the partial sums."""
    _, d_inner, _, _ = _dims(cfg)
    w = tp.whole(params["out_proj"], 1, cfg.d_model)
    if tp.split(w.shape[0], d_inner):
        return tp.reduce_from(tp.split_to(y.to(x_dtype)) @ w)
    tp.replicated("ssm out_proj")
    return y.to(x_dtype) @ w


def _scan_split(xh, dtv, a, Bm, Cm, D, spec):
    """The chunked scan and D skip on this rank's heads: (y (B, L, H, P)
    float32, gathered over 'model'; this rank's heads' final state (B,
    H / m, P, N), as the cache holds it)."""
    xh = tp.split_to(xh, dim=2)
    y, state = _ssd_chunked(xh, tp.split_to(dtv), tp.split_to(a, dim=0),
                            tp.copy_to(Bm), tp.copy_to(Cm), spec.chunk)
    y = y + tp.split_to(D, dim=0)[None, None, :, None] * xh
    return tp.gather_from(y, dim=2), state


def _vectors(params):
    """The per-head ``dt_bias``, ``A_log`` and ``D``, ``sharding.tp.
    shared`` over 'data'."""
    return (tp.shared(params["dt_bias"]), tp.shared(params["A_log"]),
            tp.shared(params["D"]))


def ssm_apply(params, x: torch.Tensor, cfg, cache=None):
    """Full-sequence Mamba-2 block.  Returns (y, new_cache).

    With ``cache`` (prefill), the new cache holds the final SSD state and
    the last ``conv_width - 1`` pre-conv inputs, for later decode steps;
    over a mesh, at their placements: this rank's heads' state and its
    channels' tail, every 'data' rank's rows where the step split them.
    """
    spec, d_inner, n_heads, conv_dim = _dims(cfg)
    b, l, _ = x.shape
    zxbcdt = _proj_in(params, x, cfg)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv, conv_split = _conv_params(params, cfg)
    if conv_split:
        xbc = tp.split_to(xbc)          # this rank's channels
        xbc_conv = tp.gather_from(_conv_full(conv, xbc))
    else:
        xbc_conv = _conv_full(conv, xbc)
    xs = xbc_conv[..., :d_inner]
    Bm = xbc_conv[..., d_inner: d_inner + spec.d_state]
    Cm = xbc_conv[..., d_inner + spec.d_state:]
    dt_bias, a_log, D = _vectors(params)
    dtv = softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log)
    xh = xs.reshape(b, l, n_heads, spec.head_dim)
    if _heads_split(cfg):
        y, final_state = _scan_split(xh.float(), dtv, a, Bm, Cm, D, spec)
    else:
        y, final_state = _ssd_chunked(xh.float(), dtv, a, Bm, Cm, spec.chunk)
        y = y + D[None, None, :, None] * xh.float()
    y = y.reshape(b, l, d_inner)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    out = _proj_out(params, y, x.dtype, cfg)
    if cache is not None:
        tail = xbc[:, -(spec.conv_width - 1):, :]
        cache = {"ssm_state": tp.all_rows(final_state),
                 "conv_state": tp.all_rows(
                     tail.to(cache["conv_state"].dtype))}
    return out, cache


def ssm_decode_step(params, x: torch.Tensor, cfg, cache: dict):
    """Single-token recurrent step.  x: (B, 1, d).  Returns (y (B, 1, d),
    new cache)."""
    spec, d_inner, n_heads, conv_dim = _dims(cfg)
    b = x.shape[0]
    zxbcdt = _proj_in(params, x[:, 0, :], cfg)   # (B, d_in_proj)
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    # depthwise conv via the cached tail (over a mesh the cache's
    # channels and heads are this rank's, at their placements: the window
    # is this rank's channels and the scan updates its heads' state)
    conv_state = tp.own_rows(cache["conv_state"])  # (B, W-1, conv_dim)
    conv, conv_split = _conv_params(params, cfg)
    if conv_split:
        xbc = tp.split_to(xbc)
    window = torch.cat([conv_state.float(), xbc.float()[:, None, :]], 1)
    w = conv["conv_w"].float()                   # (W, conv_dim)
    conv_out = (torch.einsum("bwc,wc->bc", window, w)
                + conv["conv_b"].float())
    xbc_c = F.silu(conv_out)
    if conv_split:
        xbc_c = tp.gather_from(xbc_c)
    new_conv_state = window[:, 1:, :].to(conv_state.dtype)

    xs = xbc_c[..., :d_inner]
    Bm = xbc_c[..., d_inner: d_inner + spec.d_state]
    Cm = xbc_c[..., d_inner + spec.d_state:]
    dt_bias, a_log, D = _vectors(params)
    dtv = softplus(dt.float() + dt_bias)         # (B, H)
    a = -torch.exp(a_log)                        # (H,)
    dA = torch.exp(dtv * a)                      # (B, H)
    xh = xs.reshape(b, n_heads, spec.head_dim).float()

    st = tp.own_rows(cache["ssm_state"])         # (B, H, P, N)
    split = _heads_split(cfg)
    if split:
        # this rank's heads; y is gathered over 'model'
        dA, dtv, xh, D = (tp.split_to(dA), tp.split_to(dtv),
                          tp.split_to(xh, dim=1), tp.split_to(D, dim=0))
    # dt x B x x as an outer product: (dt ⊙ x) first, then with B
    st = (st * dA[..., None, None]
          + (dtv[..., None] * xh)[..., None] * Bm.float()[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), st)
    y = y + D[None, :, None] * xh
    if split:
        y = tp.gather_from(y, dim=1)
    y = y.reshape(b, d_inner)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    out = _proj_out(params, y, x.dtype, cfg)
    return out[:, None, :], {"ssm_state": tp.all_rows(st),
                             "conv_state": tp.all_rows(new_conv_state)}
