"""Fold packed payloads into (num, den): CUDA kernel wrappers + plain
versions.

``packed_accum`` replaces the Pallas kernel ``repro/kernels/packed_accum.py:
packed_accum_flat`` (one payload); ``packed_accum_rows`` replaces
``packed_accum_rows`` there (K payloads into the K rows of stacked
accumulators, one launch, one shared alpha).  With ``words`` a payload's
bitmap (int32 words holding the reference's little-endian uint32 bits) and
``values`` its nnz held values in coordinate order, in place::

    num += alpha * scatter(values at the set bits)
    den += bits

The block offsets (exclusive prefix of per-1024-block popcounts) are made
on the device: a popcount kernel, then ``torch.cumsum`` (along each row
for the stacked fold).  Both wrappers run their plain version for CPU
tensors and launch ``csrc/packed_accum.cu`` for CUDA tensors (or raise) —
no fallback.  Both raise ``ValueError`` when a bitmap's set bits are not
exactly its value count (``values.numel()``, or ``nnz[k]`` for row k); on
the card that check reads one flag back to the host (one synchronisation
per fold).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.sparse.packed import n_words, unpack_bits, unpack_bits_rows

#: fold-kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0
#: stacked (row) fold-kernel launches since the last reset
LAUNCHES_ROWS = 0

BLOCK_N = 1024                  # coordinates per block, as in csrc/packed_accum.cu
_ENTRY = {torch.float32: "packed_accum_f32", torch.float16: "packed_accum_f16"}
# (words, counts, n_words, n_blocks, stream)
_POP_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p)
# (num, den, words, values, offsets, alpha, n, n_words, nnz, stream)
_FOLD_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# (words, counts, k, n_words, n_blocks, stream)
_POP_ROWS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# (num, den, words, values, offsets, alpha, k, n, n_words, vstride, stream)
_ROWS_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)
MAX_ROWS = 65535                # MAX_ROWS in csrc/packed_accum.cu


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


# ---------------------------------------------------------------------------
# The stacked fold: K payloads into K accumulator rows
# ---------------------------------------------------------------------------


def packed_accum_rows_plain(num: torch.Tensor, den: torch.Tensor,
                            words: torch.Tensor, values: torch.Tensor,
                            nnz: torch.Tensor, alpha: float = 1.0):
    """The row kernel's arithmetic in PyTorch ops, in place on ``num`` and
    ``den`` (K, N): row k folds the first ``nnz[k]`` values of
    ``values[k]`` at the set bits of ``words[k]``."""
    k, n = num.shape
    flags = unpack_bits_rows(words, n)
    _check_rows_nnz(flags.sum(dim=1), nnz, values.shape[1])
    held = (torch.arange(values.shape[1], device=values.device)[None, :]
            < nnz.to(torch.int64)[:, None])
    contrib = torch.zeros_like(num)
    contrib[flags] = values[held].to(num.dtype)
    num.add_(alpha * contrib)
    den.add_(flags.to(den.dtype))
    return num, den


def _check_rows(num, den, words, values, nnz) -> None:
    for name, t in (("num", num), ("den", den), ("words", words),
                    ("values", values)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be 2-D (K, ...) and contiguous")
    for name, t in (("den", den), ("words", words), ("values", values),
                    ("nnz", nnz)):
        if t.device != num.device:
            raise ValueError(f"{name} on {t.device}, num on {num.device}")
    if num.dtype != torch.float32 or den.dtype != torch.float32:
        raise TypeError("num and den must be float32")
    k, n = num.shape
    if den.shape != num.shape:
        raise ValueError(f"den is {tuple(den.shape)}, num {tuple(num.shape)}")
    if words.dtype != torch.int32 or words.shape != (k, n_words(n)):
        raise ValueError(f"words must be ({k}, {n_words(n)}) int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if values.dtype != torch.float32 or values.shape[0] != k:
        raise TypeError(f"values must be ({k}, max_nnz) float32, "
                        f"got {tuple(values.shape)} {values.dtype}")
    if nnz.dtype != torch.int32 or nnz.shape != (k,):
        raise ValueError(f"nnz must be ({k},) int32, got {tuple(nnz.shape)} "
                         f"{nnz.dtype}")
    if k > MAX_ROWS:
        raise ValueError(f"{k} rows exceed the kernel's {MAX_ROWS}")
    if max(n, values.shape[1]) >= 2 ** 31:
        raise ValueError("a row exceeds int32 indexing")


def _check_rows_nnz(set_bits: torch.Tensor, nnz: torch.Tensor,
                    width: int) -> None:
    """One read-back: every row's set bits equal its nnz, within width."""
    nnz = nnz.to(torch.int64)
    if bool(((set_bits != nnz) | (nnz > width)).any()):
        raise ValueError(f"the bitmaps hold {set_bits.tolist()} set bits per "
                         f"row but nnz is {nnz.tolist()} (values width "
                         f"{width})")


def packed_accum_rows(num: torch.Tensor, den: torch.Tensor,
                      words: torch.Tensor, values: torch.Tensor,
                      nnz: torch.Tensor, alpha: float = 1.0):
    """Fold payload k into row k of ``num``/``den`` (K, N) in place, for all
    K rows in one launch; returns them.  ``values`` is (K, max_nnz), row k's
    values left-aligned; ``nnz`` (K,) int32 on the same device."""
    global LAUNCHES_ROWS
    _check_rows(num, den, words, values, nnz)
    if num.device.type == "cpu":
        return packed_accum_rows_plain(num, den, words, values, nnz, alpha)
    if num.device.type != "cuda":
        raise ValueError(f"unsupported device {num.device}")
    k, n = num.shape
    if n == 0 or k == 0:
        return num, den
    stream = torch.cuda.current_stream(num.device).cuda_stream
    n_blocks = (n + BLOCK_N - 1) // BLOCK_N
    counts = torch.empty((k, n_blocks), dtype=torch.int32, device=num.device)
    pop = build.function("packed_accum", "block_popcount_rows",
                         _POP_ROWS_ARGTYPES)
    fold = build.function("packed_accum", "packed_accum_rows_f32",
                          _ROWS_ARGTYPES)
    with torch.cuda.device(num.device):
        build.check(pop(words.data_ptr(), counts.data_ptr(), k, words.shape[1],
                        n_blocks, stream), "block_popcount_rows")
        _check_rows_nnz(counts.sum(dim=1), nnz, values.shape[1])
        offsets = torch.cumsum(counts, 1, dtype=torch.int32) - counts
        build.check(fold(num.data_ptr(), den.data_ptr(), words.data_ptr(),
                         values.data_ptr(), offsets.data_ptr(), float(alpha),
                         k, n, words.shape[1], values.shape[1], stream),
                    "packed_accum_rows")
    LAUNCHES_ROWS += 1
    return num, den
