"""Intersection-weighted gossip average: CUDA kernel wrapper + plain version.

Replaces the Pallas kernel ``repro/kernels/gossip_avg.py:gossip_avg_flat``.
For J received rows (self first)::

    out = (sum_j W[j]) / max(sum_j M[j], 1) * own

The rows must already be masked (``W[j] == W[j] * M[j]``): the state the
mix sees always is (masked SGD, evolve and the packed decode keep it so),
and the Pallas kernel assumes the same.  Unmasked rows are summed as they
are, not re-masked.

``gossip_avg`` runs the plain version for CPU tensors and launches
``csrc/gossip_avg.cu`` for CUDA tensors (or raises) — there is no fallback.
The rows are handed over as a list, which is a (J, N) stack without the copy
into one; ``list(stack)`` passes a real stack.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0

MAX_J = 32                       # GOSSIP_MAX_J in csrc/gossip_avg.cu
_ENTRY = {torch.float32: "gossip_avg_f32", torch.bfloat16: "gossip_avg_bf16"}
#: of ``LAUNCHES``, each C entry's
LAUNCHES_BY_ENTRY = dict.fromkeys(_ENTRY.values(), 0)
build.counts_launches(__name__)
# (w_ptrs, m_ptrs, J, own, out, n, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def gossip_avg_plain(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                     own: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: rows summed in stack order in
    fp32, IEEE divide, result in the rows' dtype."""
    num = ws[0].float()
    den = ms[0].float()
    for w, m in zip(ws[1:], ms[1:]):
        num = num + w.float()
        den = den + m.float()
    return ((num / torch.clamp_min(den, 1.0)) * own.float()).to(ws[0].dtype)


def _check(ws, ms, own) -> None:
    if len(ws) != len(ms) or not ws:
        raise ValueError(f"need J >= 1 rows of W and of M, got {len(ws)} "
                         f"and {len(ms)}")
    if len(ws) > MAX_J:
        raise ValueError(f"J={len(ws)} rows exceed the kernel's {MAX_J}")
    if own.dtype not in _ENTRY:
        raise TypeError(f"dtype must be float32 or bfloat16, got {own.dtype}")
    for t in (*ws, *ms):
        if t.shape != own.shape or t.dtype != own.dtype:
            raise ValueError(
                f"every row must match own {tuple(own.shape)} {own.dtype}, "
                f"got {tuple(t.shape)} {t.dtype}")
        if t.device != own.device:
            raise ValueError(f"rows on {t.device}, own on {own.device}")
        if not t.is_contiguous():
            raise ValueError("rows must be contiguous")
    if not own.is_contiguous():
        raise ValueError("own must be contiguous")
    if own.numel() >= 2 ** 31:
        raise ValueError(f"{own.numel()} coordinates exceed int32 indexing")


def gossip_avg(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
               own: torch.Tensor) -> torch.Tensor:
    """Intersection average of J same-shape rows; returns a new tensor
    shaped like ``own``."""
    global LAUNCHES
    _check(ws, ms, own)
    if own.device.type == "cpu":
        return gossip_avg_plain(ws, ms, own)
    if own.device.type != "cuda":
        raise ValueError(f"unsupported device {own.device}")
    out = torch.empty_like(own)
    n = own.numel()
    if n == 0:
        return out
    fn = build.function("gossip_avg", _ENTRY[own.dtype], _ARGTYPES)
    j = len(ws)
    # host arrays of device pointers; the C entry copies them into the
    # launch's parameters before it returns
    w_ptrs = (ctypes.c_void_p * j)(*[t.data_ptr() for t in ws])
    m_ptrs = (ctypes.c_void_p * j)(*[t.data_ptr() for t in ms])
    build.check(build.launch(
        fn, own, ctypes.cast(w_ptrs, ctypes.c_void_p),
        ctypes.cast(m_ptrs, ctypes.c_void_p), j, own.data_ptr(),
        out.data_ptr(), n), "gossip_avg")
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[_ENTRY[own.dtype]] += 1
    return out
