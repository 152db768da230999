"""Block-sparse masked matmul: CUDA kernel wrapper + plain version.

Replaces the Pallas kernels ``repro/kernels/masked_matmul.py``:
``batched_masked_matmul`` (the serving launch, one per MLP layer) and
``masked_matmul``, its U=1 form, together with their padding wrappers in
``repro/kernels/ops.py``::

    y[u] = x[u] @ (w[u] * m[u])      x (U, M, K), w and m (U, K, N)

in fp32, or with bf16 x and w (the reference's bf16 path: the mask cast to
w's type, an fp32 accumulator, y in x's type), the mask fp32 or bf16 —
the ``(x and w, m)`` dtype pairs of ``PAIRS``.  The wrappers run the plain
version for CPU tensors and launch ``csrc/masked_matmul.cu`` for CUDA
tensors (or raise) — there is no fallback: fp32 operands on the CUDA cores
(no TF32), bf16 ones on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulation), each entry at the same tile.  The kernels skip empty
(``TILE_K``, ``TILE_N``) mask tiles and masks ragged edges itself, so
nothing is padded on the host.  Only contiguous operands are taken, on
either device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0
#: of those, the launches made through the U=1 wrapper ``masked_matmul``
LAUNCHES_U1 = 0

# MMK_BM, MMK_BN, MMK_BK in csrc/masked_matmul.cu: the CTA tile of every
# entry (the fp32 kernel's and the bf16 tensor-core kernel's: rows, columns
# of one strip) and the tile whose empty mask both skip; the grid is
# (N / TILE_N, M / TILE_M, U) for every entry
TILE_M, TILE_N, TILE_K = 16, 32, 32
MAX_GRID_YZ = 65535
# (x, w, m, y, U, M, K, wU, wK, wN, mU, mK, mN, stream): the C entry checks
# the dimensions itself (int64, so none is truncated on the way)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 9 + (ctypes.c_void_p,)
# what the C entry returns for shapes it refuses (cudaErrorInvalidValue,
# cudaErrorInvalidConfiguration)
_REFUSED = (1, 9)
_F32 = torch.float32
#: (x and w dtype, m dtype) -> C entry of csrc/masked_matmul.cu
_ENTRY = {(torch.float32, torch.float32): "batched_masked_matmul_f32",
          (torch.bfloat16, torch.float32): "batched_masked_matmul_bf16",
          (torch.bfloat16, torch.bfloat16):
              "batched_masked_matmul_bf16_mbf16"}
PAIRS = tuple(_ENTRY)
#: of ``LAUNCHES`` and of ``LAUNCHES_U1``, each C entry's
LAUNCHES_BY_ENTRY = dict.fromkeys(_ENTRY.values(), 0)
LAUNCHES_U1_BY_ENTRY = dict.fromkeys(_ENTRY.values(), 0)
build.counts_launches(__name__)


def batched_masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                                m: torch.Tensor) -> torch.Tensor:
    """``x @ (w * m)`` per user (the reference's
    ``kernels.ref.batched_masked_matmul_ref``): in fp32, or for bf16
    operands ``w * m`` in w's type (exact for a 0/1 mask), multiplied in
    fp32 and rounded to x's type once."""
    if x.dtype == _F32:
        return torch.matmul(x, w * m)
    return torch.matmul(x.float(), (w * m.to(w.dtype)).float()).to(x.dtype)


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
    """``x @ (w * m)`` (``kernels.ref.masked_matmul_ref``), typed as
    ``batched_masked_matmul_plain``."""
    return batched_masked_matmul_plain(x, w, m)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at each ``|t|`` (0 at 0): ``2^(e - 7)``
    for ``|t|`` in ``[2^e, 2^(e + 1))``, between 2^-8 and 2^-7 of ``|t|``."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t.float()),
                                                e - 8))


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor,
                    atol: float = 1e-5) -> bool:
    """The bf16 entries' contract against their plain version: each
    output within one bf16 ulp of the plain one, plus the fp32 kernel's
    ``atol`` (both round one fp32 sum, summed in another order, to
    bf16)."""
    return bool(((got.float() - want.float()).abs()
                 <= bf16_ulp(want) + atol).all())


def _check(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or m.dim() != 3:
        raise ValueError(f"need x (U, M, K), w and m (U, K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(m.shape)}")
    u, _, k = x.shape
    if w.shape != m.shape or w.shape[0] != u or w.shape[1] != k:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, m {tuple(m.shape)}")
    if (x.dtype, m.dtype) not in _ENTRY or w.dtype != x.dtype:
        pairs = ", ".join(f"({a}, {b})".replace("torch.", "")
                          for a, b in PAIRS)
        raise TypeError(f"(x, w, m) dtypes ({x.dtype}, {w.dtype}, {m.dtype}) "
                        f"are not taken: w must have x's dtype and (x, m) be "
                        f"one of {pairs}")
    for name, t in (("x", x), ("w", w), ("m", m)):
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
    a new (U, M, N) tensor of x's dtype.

    On the card only what the C entry cannot see is checked here (types,
    layout, device); it checks the shapes itself, and a refusal is turned
    into ``_check``'s message."""
    global LAUNCHES
    entry = _ENTRY.get((x.dtype, m.dtype))
    if not (x.is_cuda and entry is not None and w.dtype is x.dtype
            and x.is_contiguous() and w.is_contiguous()
            and m.is_contiguous() and x.dim() == w.dim() == m.dim() == 3
            and x.get_device() == w.get_device() == m.get_device()):
        _check(x, w, m)
        if x.device.type == "cpu":
            return batched_masked_matmul_plain(x, w, m)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
    u, rows, k = x.shape
    y = x.new_empty((u, rows, w.shape[2]))
    fn = build.function("masked_matmul", _ENTRY[x.dtype, m.dtype], _ARGTYPES)
    err = build.launch(fn, x, x.data_ptr(), w.data_ptr(), m.data_ptr(),
                       y.data_ptr(), u, rows, k, *w.shape, *m.shape)
    if err in _REFUSED:
        _check(x, w, m)
    build.check(err, "batched_masked_matmul")
    if y.numel():
        LAUNCHES += 1
        LAUNCHES_BY_ENTRY[_ENTRY[x.dtype, m.dtype]] += 1
    return y


def masked_matmul(x: torch.Tensor, w: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """``y = x @ (w * m)`` for x (M, K), w and m (K, N): the batched kernel
    at U=1."""
    global LAUNCHES_U1
    if x.dim() != 2 or w.dim() != 2 or m.dim() != 2:
        raise ValueError(f"need x (M, K), w and m (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(m.shape)}")
    launches = LAUNCHES
    y = batched_masked_matmul(x[None], w[None], m[None])[0]
    if LAUNCHES != launches:
        LAUNCHES_U1 += 1
        LAUNCHES_U1_BY_ENTRY[_ENTRY[x.dtype, m.dtype]] += 1
    return y


def block_mask_from_mask(mask: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(K, N) coordinate mask -> (K/bk, N/bn) int32 block occupancy (1
    where the tile holds a non-zero); the shape must tile evenly."""
    return batched_block_mask(mask[None], bk, bn)[0]


def batched_block_mask(mask: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(U, K, N) coordinate masks -> (U, K/bk, N/bn) int32 block
    occupancy."""
    u, k, n = mask.shape
    mb = mask.reshape(u, k // bk, bk, n // bn, bn)
    return ((mb != 0).sum(dim=(2, 4)) > 0).to(torch.int32)


def block_occupancy(mask: torch.Tensor, bk: int = 128, bn: int = 128) -> float:
    """Share of (bk, bn) tiles of a (..., K, N) mask that hold a non-zero
    (reference ``kernels.ops.block_occupancy``, which takes one (K, N)
    mask).  Ragged edges are padded with zeros, as the reference pads.
    The default tile is the reference's; the CUDA kernel skips empty
    (``TILE_K``, ``TILE_N``) tiles."""
    k, n = mask.shape[-2:]
    nz = F.pad((mask != 0).to(torch.float32), (0, (-n) % bn, 0, (-k) % bk))
    blocks = batched_block_mask(nz.reshape(-1, *nz.shape[-2:]), bk, bn)
    return float(blocks.to(torch.float32).mean())
