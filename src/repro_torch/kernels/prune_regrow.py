"""Threshold prune + gradient regrow (the Alg. 2 apply): CUDA kernel wrapper
+ plain version, and the threshold selection around it.

Replaces the Pallas kernel ``repro/kernels/prune_regrow.py:
prune_regrow_flat``.  ``prune_regrow_rows`` applies, to K rows at once with
per-row thresholds ``(w_th, g_th)`` held in a (K, 2) tensor on the device::

    keep   = m > 0  &  |w| >= w_th
    grown  = m <= 0 &  |g| >= g_th  &  |g| > 0
    new_m  = keep | grown,   new_w = keep ? w : +0.0

w and g share one type, m may have another; every value is widened to
fp32 before it is compared (exact), and the outputs keep m's and w's
types, as the Pallas body does.  The (w, m) pairs taken are ``PAIRS``:
(float32, float32), (float32, int8), (bfloat16, int8) and (bfloat16,
bfloat16); any other raises ``TypeError``, on either device.
It runs the plain version for CPU tensors and launches
``csrc/prune_regrow.cu`` for CUDA tensors (or raises) — no fallback.  The
thresholds are kth order statistics picked by ``torch.sort`` on the device
(``sort_thresholds``, in the weights' own type), as the reference picks
them with ``jnp.sort`` outside its kernel; ``prune_regrow`` is the one-layer entry point of
``repro/kernels/ops.py:prune_regrow``.  Threshold semantics keep or grow a
few more coordinates than the exact-count evolve on ties.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0

MAX_ROWS = 65535                # MAX_ROWS in csrc/prune_regrow.cu
#: (w and g dtype, m dtype) -> C entry of csrc/prune_regrow.cu
_ENTRY = {(torch.float32, torch.float32): "prune_regrow_rows_f32",
          (torch.float32, torch.int8): "prune_regrow_rows_f32_i8",
          (torch.bfloat16, torch.int8): "prune_regrow_rows_bf16_i8",
          (torch.bfloat16, torch.bfloat16): "prune_regrow_rows_bf16"}
PAIRS = tuple(_ENTRY)
#: of ``LAUNCHES``, each C entry's
LAUNCHES_BY_ENTRY = dict.fromkeys(_ENTRY.values(), 0)
build.counts_launches(__name__)
# (w, g, m, th, new_m, new_w, k, n, stream)
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)


def prune_regrow_rows_plain(w: torch.Tensor, g: torch.Tensor,
                            m: torch.Tensor, thresholds: torch.Tensor):
    """The kernel's arithmetic in PyTorch ops; returns (new_m, new_w).
    Comparing a bf16 or int8 tensor with the fp32 thresholds promotes it
    to fp32 exactly, as the kernel widens it."""
    w_th, g_th = thresholds[:, 0:1], thresholds[:, 1:2]
    ag = g.abs()
    keep = (m > 0) & (w.abs() >= w_th)
    grown = (m <= 0) & (ag >= g_th) & (ag > 0)
    return (keep | grown).to(m.dtype), torch.where(keep, w, 0.0)


def _check(w, g, m, thresholds) -> None:
    if (w.dtype, m.dtype) not in _ENTRY or g.dtype != w.dtype:
        pairs = ", ".join(f"({a}, {b})".replace("torch.", "")
                          for a, b in PAIRS)
        raise TypeError(f"(w, g, m) dtypes ({w.dtype}, {g.dtype}, {m.dtype}) "
                        f"are not taken: g must have w's dtype and (w, m) be "
                        f"one of {pairs}")
    for name, t in (("w", w), ("g", g), ("m", m)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be 2-D (K, N) and contiguous")
        if t.shape != w.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, w "
                             f"{tuple(w.shape)}")
    k, n = w.shape
    if (thresholds.dtype != torch.float32 or thresholds.shape != (k, 2)
            or not thresholds.is_contiguous()):
        raise ValueError(f"thresholds must be a contiguous ({k}, 2) float32 "
                         f"tensor, got {tuple(thresholds.shape)} "
                         f"{thresholds.dtype}")
    for name, t in (("g", g), ("m", m), ("thresholds", thresholds)):
        if t.device != w.device:
            raise ValueError(f"{name} on {t.device}, w on {w.device}")
    if k > MAX_ROWS:
        raise ValueError(f"{k} rows exceed the kernel's {MAX_ROWS}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} coordinates exceed int32 indexing")


def prune_regrow_rows(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      thresholds: torch.Tensor):
    """Apply row k's ``thresholds[k] = (w_th, g_th)`` to row k of (K, N)
    ``w``, ``g``, ``m`` (a pair of ``PAIRS``); returns new tensors
    ``(new_m, new_w)`` of m's and w's dtypes."""
    global LAUNCHES
    _check(w, g, m, thresholds)
    if w.device.type == "cpu":
        return prune_regrow_rows_plain(w, g, m, thresholds)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    new_m, new_w = torch.empty_like(m), torch.empty_like(w)
    k, n = w.shape
    if k == 0 or n == 0:
        return new_m, new_w
    fn = build.function("prune_regrow", _ENTRY[w.dtype, m.dtype], _ARGTYPES)
    build.check(build.launch(
        fn, w, w.data_ptr(), g.data_ptr(), m.data_ptr(),
        thresholds.data_ptr(), new_m.data_ptr(), new_w.data_ptr(), k, n),
        "prune_regrow")
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[_ENTRY[w.dtype, m.dtype]] += 1
    return new_m, new_w


def _column(sorted_desc: torch.Tensor, count) -> torch.Tensor:
    """Per row, the value at rank ``max(count - 1, 0)`` of a descending
    sort; ``count`` is an int or a (K,) integer tensor on the device."""
    k = sorted_desc.shape[0]
    idx = (count.to(torch.int64) if isinstance(count, torch.Tensor) else
           torch.full((), count, dtype=torch.int64, device=sorted_desc.device))
    idx = torch.clamp_min(idx.reshape(-1).expand(k) - 1, 0)
    return sorted_desc.gather(1, idx[:, None])[:, 0]


def sort_thresholds(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    n_keep, n_prune) -> torch.Tensor:
    """(K, 2) float32 ``(w_th, g_th)`` per row of (K, N) tensors: the
    ``n_keep``-th largest |w| among held coordinates and the
    ``n_prune``-th largest |g| among the others (``-inf`` marks excluded
    coordinates), by ``torch.sort`` on the device in w's and g's own
    dtype (half the bytes at bf16).  The widening to fp32 is exact, so
    the thresholds equal those of a sort of the fp32 widenings."""
    neg_inf = torch.full((), float("-inf"), dtype=w.dtype, device=w.device)
    keep_sorted = torch.sort(torch.where(m > 0, w.abs(), neg_inf), dim=1,
                             descending=True).values
    grow_sorted = torch.sort(torch.where(m > 0, neg_inf, g.abs()), dim=1,
                             descending=True).values
    return torch.stack([_column(keep_sorted, n_keep),
                        _column(grow_sorted, n_prune)],
                       dim=1).to(torch.float32).contiguous()


def prune_regrow(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 prune_rate: float):
    """Threshold-based Alg. 2 apply for one layer (reference
    ``repro/kernels/ops.py:prune_regrow``): prune the ``ceil(rate *
    n_active)`` smallest held weights, regrow as many by gradient, with
    the counts and thresholds computed on the device.  Returns
    ``(new_mask, new_weights)`` shaped and typed like ``m`` and ``w``."""
    wf = w.reshape(1, -1).to(torch.float32)
    gf = g.reshape(1, -1).to(torch.float32)
    mf = m.reshape(1, -1).to(torch.float32)
    n_active = (mf > 0).sum(dim=1)
    rate = torch.tensor(prune_rate, dtype=torch.float32, device=w.device)
    n_prune = torch.ceil(n_active.to(torch.float32) * rate).to(torch.int64)
    th = sort_thresholds(wf, gf, mf, n_active - n_prune, n_prune)
    new_m, new_w = prune_regrow_rows(wf.contiguous(), gf.contiguous(),
                                     mf.contiguous(), th)
    return new_m.reshape(m.shape).to(m.dtype), new_w.reshape(w.shape).to(w.dtype)
