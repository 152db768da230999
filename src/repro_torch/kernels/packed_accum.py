"""Fold one packed payload into (num, den): CUDA kernel wrapper + plain
version.

Replaces the Pallas kernel ``repro/kernels/packed_accum.py:
packed_accum_flat``.  With ``words`` the payload's bitmap (int32 words
holding the reference's little-endian uint32 bits) and ``values`` its nnz
held values in coordinate order, in place::

    num += alpha * scatter(values at the set bits)
    den += bits

The block offsets (exclusive prefix of per-1024-block popcounts) are made
on the device: a popcount kernel, then ``torch.cumsum``.  ``packed_accum``
runs the plain version for CPU tensors and launches
``csrc/packed_accum.cu`` for CUDA tensors (or raises) — no fallback.  Both
raise ``ValueError`` when the bitmap's set bits are not exactly
``values.numel()``; on the card that check reads the popcount back to the
host (one synchronisation per fold).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.sparse.packed import n_words, unpack_bits

#: fold-kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0

BLOCK_N = 1024                  # coordinates per block, as in csrc/packed_accum.cu
_ENTRY = {torch.float32: "packed_accum_f32", torch.float16: "packed_accum_f16"}
# (words, counts, n_words, n_blocks, stream)
_POP_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p)
# (num, den, words, values, offsets, alpha, n, n_words, nnz, stream)
_FOLD_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def packed_accum_plain(num: torch.Tensor, den: torch.Tensor,
                       words: torch.Tensor, values: torch.Tensor,
                       alpha: float = 1.0):
    """The kernel's arithmetic in PyTorch ops (separately rounded multiply
    and add), in place on ``num`` and ``den``."""
    flags = unpack_bits(words, num.numel())
    _check_nnz(int(flags.sum()), values)
    contrib = torch.zeros_like(num)
    contrib[flags] = values.to(num.dtype)
    num.add_(alpha * contrib)
    den.add_(flags.to(den.dtype))
    return num, den


def _check(num, den, words, values) -> None:
    for name, t in (("num", num), ("den", den), ("words", words),
                    ("values", values)):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
        if t.device != num.device:
            raise ValueError(f"{name} on {t.device}, num on {num.device}")
    if num.dtype != torch.float32 or den.dtype != torch.float32:
        raise TypeError("num and den must be float32")
    if den.numel() != num.numel():
        raise ValueError(f"den has {den.numel()} coords, num {num.numel()}")
    if words.dtype != torch.int32 or words.numel() != n_words(num.numel()):
        raise ValueError(f"words must be {n_words(num.numel())} int32, got "
                         f"{words.numel()} {words.dtype}")
    if values.dtype not in _ENTRY:
        raise TypeError(f"values must be float32 or float16, got "
                        f"{values.dtype}")
    if num.numel() >= 2 ** 31:
        raise ValueError(f"{num.numel()} coordinates exceed int32 indexing")


def _check_nnz(set_bits: int, values: torch.Tensor) -> None:
    if set_bits != values.numel():
        raise ValueError(f"the bitmap holds {set_bits} set bits but there "
                         f"are {values.numel()} values")


def packed_accum(num: torch.Tensor, den: torch.Tensor, words: torch.Tensor,
                 values: torch.Tensor, alpha: float = 1.0):
    """Fold one payload into ``num``/``den`` in place; returns them."""
    global LAUNCHES
    _check(num, den, words, values)
    if num.device.type == "cpu":
        return packed_accum_plain(num, den, words, values, alpha)
    if num.device.type != "cuda":
        raise ValueError(f"unsupported device {num.device}")
    n = num.numel()
    if n == 0:
        return num, den
    stream = torch.cuda.current_stream(num.device).cuda_stream
    n_blocks = (n + BLOCK_N - 1) // BLOCK_N
    counts = torch.empty(n_blocks, dtype=torch.int32, device=num.device)
    pop = build.function("packed_accum", "block_popcount", _POP_ARGTYPES)
    fold = build.function("packed_accum", _ENTRY[values.dtype], _FOLD_ARGTYPES)
    with torch.cuda.device(num.device):
        build.check(pop(words.data_ptr(), counts.data_ptr(), words.numel(),
                        n_blocks, stream), "block_popcount")
        _check_nnz(int(counts.sum()), values)
        offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        build.check(fold(num.data_ptr(), den.data_ptr(), words.data_ptr(),
                         values.data_ptr(), offsets.data_ptr(), float(alpha),
                         n, words.numel(), values.numel(), stream),
                    "packed_accum")
    LAUNCHES += 1
    return num, den
