"""Block-sparse masked matmul: CUDA kernel wrapper + plain version.

Replaces the Pallas kernels ``repro/kernels/masked_matmul.py``:
``batched_masked_matmul`` (the serving launch, one per MLP layer) and
``masked_matmul``, its U=1 form, together with their padding wrappers in
``repro/kernels/ops.py``::

    y[u] = x[u] @ (w[u] * m[u])      x (U, M, K), w and m (U, K, N), fp32

The wrappers run the plain version for CPU tensors and launch
``csrc/masked_matmul.cu`` for CUDA tensors (or raise) — there is no
fallback.  The kernel skips empty (``TILE_K``, ``TILE_N``) mask tiles and
masks ragged edges itself, so nothing is padded on the host.  Only
contiguous fp32 operands are taken, on either device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0

# MMK_BM, MMK_BN, MMK_BK in csrc/masked_matmul.cu: the CUDA tile, and the
# tile whose empty mask the kernel skips
TILE_M, TILE_N, TILE_K = 16, 32, 32
MAX_GRID_YZ = 65535
# (x, w, m, y, U, M, K, N, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def batched_masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                                m: torch.Tensor) -> torch.Tensor:
    """``x @ (w * m)`` per user, in fp32 (the reference's
    ``kernels.ref.batched_masked_matmul_ref``)."""
    return torch.matmul(x, w * m)


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
    """``x @ (w * m)`` in fp32 (``kernels.ref.masked_matmul_ref``)."""
    return torch.matmul(x, w * m)


def _check(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or m.dim() != 3:
        raise ValueError(f"need x (U, M, K), w and m (U, K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(m.shape)}")
    u, _, k = x.shape
    if w.shape != m.shape or w.shape[0] != u or w.shape[1] != k:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, m {tuple(m.shape)}")
    for name, t in (("x", x), ("w", w), ("m", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x.shape + w.shape) >= 2 ** 31:
        raise ValueError("a dimension exceeds int32")
    if u > MAX_GRID_YZ or -(-x.shape[1] // TILE_M) > MAX_GRID_YZ:
        raise ValueError(f"U={u} or M={x.shape[1]} exceeds the kernel's grid")


def batched_masked_matmul(x: torch.Tensor, w: torch.Tensor,
                          m: torch.Tensor) -> torch.Tensor:
    """``y[u] = x[u] @ (w[u] * m[u])`` for every user, one launch; returns
    a new (U, M, N) tensor."""
    global LAUNCHES
    _check(x, w, m)
    if x.device.type == "cpu":
        return batched_masked_matmul_plain(x, w, m)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    u, rows, k = x.shape
    n = w.shape[2]
    y = torch.empty((u, rows, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    fn = build.function("masked_matmul", "batched_masked_matmul_f32",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), m.data_ptr(), y.data_ptr(),
                 u, rows, k, n, stream)
    build.check(err, "batched_masked_matmul")
    LAUNCHES += 1
    return y


def masked_matmul(x: torch.Tensor, w: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """``y = x @ (w * m)`` for x (M, K), w and m (K, N): the batched kernel
    at U=1."""
    if x.dim() != 2 or w.dim() != 2 or m.dim() != 2:
        raise ValueError(f"need x (M, K), w and m (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(m.shape)}")
    return batched_masked_matmul(x[None], w[None], m[None])[0]


def block_occupancy(mask: torch.Tensor, bk: int = 128, bn: int = 128) -> float:
    """Share of (bk, bn) tiles of a (..., K, N) mask that hold a non-zero
    (reference ``kernels.ops.block_occupancy``, which takes one (K, N)
    mask).  Ragged edges are padded with zeros, as the reference pads.
    The default tile is the reference's; the CUDA kernel skips empty
    (``TILE_K``, ``TILE_N``) tiles."""
    k, n = mask.shape[-2:]
    nz = F.pad((mask != 0).to(torch.float32), (0, (-n) % bn, 0, (-k) % bk))
    lead = nz.shape[:-2]
    blocks = nz.reshape(*lead, nz.shape[-2] // bk, bk, nz.shape[-1] // bn, bn)
    return float(blocks.amax(dim=(-3, -1)).mean())
