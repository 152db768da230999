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

The rank offsets (exclusive prefix of the per-128-coordinate popcounts
along each row) are made on the device by one scan launch, which also
totals each row's set bits.  Every wrapper runs its plain version for CPU
tensors and launches ``csrc/packed_accum.cu`` for CUDA tensors (or raises)
— no fallback.  Each raises ``ValueError`` when a bitmap's set bits are not
exactly its value count (``values.numel()``, or ``nnz[k]`` for row k); that
check reads the scans' totals back to the host before any fold launches,
so a refused call leaves every ``num``, ``den`` and the launch counts
untouched.  ``packed_accum_all`` folds a whole payload tree (or several)
with one such read: every leaf's scan first, one read of all their totals,
then every fold.  ``packed_accum`` is its one-fold case; the plain version
takes the same single read, so a CPU run makes the reads the card makes.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.sparse.packed import n_words, unpack_bits, unpack_bits_rows

#: fold-kernel launches since the last reset (the plain version counts nothing)
LAUNCHES = 0
#: stacked (row) fold-kernel launches since the last reset
LAUNCHES_ROWS = 0

BLOCK_N = 1024                  # coordinates per fold block, as in csrc/packed_accum.cu
GROUP_N = 128                   # coordinates per rank offset, as there
SCAN_N = 256 * GROUP_N          # coordinates per scan block, as there
_ENTRY = {torch.float32: "packed_accum_f32", torch.float16: "packed_accum_f16"}
_ROWS_ENTRY = {torch.float32: "packed_accum_rows_f32",
               torch.float16: "packed_accum_rows_f16"}
#: of ``LAUNCHES`` and ``LAUNCHES_ROWS``, each C fold entry's
LAUNCHES_BY_ENTRY = dict.fromkeys((*_ENTRY.values(), *_ROWS_ENTRY.values()),
                                  0)
build.counts_launches(__name__)
# (words, offsets, res, scratch, scratch_len, nnz, expect, vstride, k, n,
#  n_words, epoch, stream)
_SCAN_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_void_p) + (
    ctypes.c_int,) * 6 + (ctypes.c_void_p,)
# (num, den, words, values, offsets, alpha, n, n_words, nnz, stream)
_FOLD_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# (num, den, words, values, offsets, alpha, k, n, n_words, vstride, stream)
_ROWS_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)
MAX_ROWS = 65535                # MAX_ROWS in csrc/packed_accum.cu
_EPOCH_MAX = 2 ** 31 - 1
# per (card, CUDA stream): [int64 scan status words (the first is the
# ticket), the epoch of the last scan]; launches on one stream are ordered,
# so they can share them (every card's default stream has the handle 0)
_SCAN_SCRATCH: dict[tuple[int, int], list] = {}


def _scan(words: torch.Tensor, k: int, n: int, nnz, expect: int,
          vstride: int, offsets: int, res: int) -> None:
    """One scan launch over K bitmap rows of n coordinates: writes the
    (K, ceil(n / GROUP_N)) int32 rank offsets at the device address
    ``offsets`` and, at ``res``, each row's set bits followed by each row's
    disagreement flag (2K int32, on the device: the caller reads them
    back).  A capture would bake the scratch epoch in, and the caller's
    read-back cannot be captured, so under a CUDA-graph capture it
    raises."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the packed fold reads its popcount check back "
                           "to the host: it cannot run inside a CUDA-graph "
                           "capture")
    card = words.get_device()
    key = (card, torch._C._cuda_getCurrentRawStream(card))
    need = 1 + k * -(-n // SCAN_N)
    scratch = _SCAN_SCRATCH.get(key)
    if scratch is None or scratch[0].numel() < need or scratch[1] >= _EPOCH_MAX:
        size = max(need, 2 * scratch[0].numel() if scratch else 0)
        scratch = [torch.zeros(size, dtype=torch.int64, device=words.device), 0]
        _SCAN_SCRATCH[key] = scratch
    # scans on one stream run one after another, so a later scan may reuse
    # the status words under a new epoch while earlier scans' folds wait:
    # each scan's offsets and totals have addresses of their own
    scratch[1] += 1
    scan = build.function("packed_accum", "packed_scan_rows", _SCAN_ARGTYPES)
    build.check(build.launch(
        scan, words, words.data_ptr(), offsets, res, scratch[0].data_ptr(),
        scratch[0].numel(), None if nnz is None else nnz.data_ptr(), expect,
        vstride, k, n, words.shape[-1], scratch[1]), "packed_scan_rows")


def _fold_plain(num, den, flags, values, alpha) -> None:
    """The kernel's arithmetic in PyTorch ops (separately rounded multiply
    and add), in place, with no host read: each held value gathered by its
    rank among the set bits."""
    contrib = torch.zeros_like(num)
    if values.numel():
        rank = (torch.cumsum(flags, 0) - 1).clamp_(0, values.numel() - 1)
        contrib = torch.where(flags, values.index_select(0, rank).to(
            num.dtype), contrib)
    num.add_(alpha * contrib)
    den.add_(flags.to(den.dtype))


def packed_accum_plain(num: torch.Tensor, den: torch.Tensor,
                       words: torch.Tensor, values: torch.Tensor,
                       alpha: float = 1.0):
    """The kernel's arithmetic in PyTorch ops (separately rounded multiply
    and add), in place on ``num`` and ``den``."""
    _fold_all_plain([(num, den, words, values, alpha)])
    return num, den


def _fold_all_plain(folds) -> None:
    """Every fold's set bits read back at once and checked, then every
    fold: the card's order and its one read."""
    flags = [unpack_bits(words, num.numel()) for num, _, words, _, _ in folds]
    set_bits = torch.stack([f.sum() for f in flags]).tolist()
    for (*_, values, _), bits in zip(folds, set_bits):
        _check_nnz(bits, values)
    for (num, den, _, values, alpha), f in zip(folds, flags):
        _fold_plain(num, den, f, values, alpha)


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


def packed_accum_all(folds: Sequence[tuple]) -> None:
    """Fold every ``(num, den, words, values, alpha)`` of ``folds`` in place,
    in order (folds into one accumulator add up in list order), with one
    read-back for all of them: every scan, one read of their set-bit
    totals, a ``ValueError`` for the first payload whose bits disagree with
    its value count (nothing folded then), then every fold.  The folds
    share one device: the card, or the CPU's plain version."""
    global LAUNCHES
    folds = list(folds)
    if not folds:
        return
    dev = folds[0][0].device
    for num, den, words, values, _ in folds:
        _check(num, den, words, values)
        if num.device != dev:
            raise ValueError(f"folds on {num.device} and {dev}")
    if dev.type == "cpu":
        return _fold_all_plain(folds)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # one buffer for every scan's totals (2 int32 a fold, first) and rank
    # offsets (ceil(n / GROUP_N) int32 a fold, after them)
    starts, at = [], 2 * len(folds)
    for num, *_ in folds:
        starts.append(at)
        at += -(-num.numel() // GROUP_N)
    buf = torch.zeros(at, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    for i, (num, _, words, values, _) in enumerate(folds):
        if num.numel():
            _scan(words, 1, num.numel(), None, values.numel(),
                  values.numel(), base + 4 * starts[i], base + 8 * i)
    set_bits = buf[:2 * len(folds)].tolist()[::2]
    for (*_, values, _), bits in zip(folds, set_bits):
        _check_nnz(bits, values)
    for (num, den, words, values, alpha), start in zip(folds, starts):
        if num.numel() == 0:
            continue
        fold = build.function("packed_accum", _ENTRY[values.dtype],
                              _FOLD_ARGTYPES)
        build.check(build.launch(
            fold, num, num.data_ptr(), den.data_ptr(), words.data_ptr(),
            values.data_ptr(), base + 4 * start, float(alpha), num.numel(),
            words.numel(), values.numel()), "packed_accum")
        LAUNCHES += 1
        LAUNCHES_BY_ENTRY[_ENTRY[values.dtype]] += 1


def packed_accum(num: torch.Tensor, den: torch.Tensor, words: torch.Tensor,
                 values: torch.Tensor, alpha: float = 1.0):
    """Fold one payload into ``num``/``den`` in place; returns them."""
    packed_accum_all([(num, den, words, values, alpha)])
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
    if values.dtype not in _ROWS_ENTRY or values.shape[0] != k:
        raise TypeError(f"values must be ({k}, max_nnz) float32 or float16, "
                        f"got {tuple(values.shape)} {values.dtype}")
    if nnz.dtype != torch.int32 or nnz.shape != (k,):
        raise ValueError(f"nnz must be ({k},) int32, got {tuple(nnz.shape)} "
                         f"{nnz.dtype}")
    if k > MAX_ROWS:
        raise ValueError(f"{k} rows exceed the kernel's {MAX_ROWS}")
    if max(n, values.shape[1]) >= 2 ** 31:
        raise ValueError("a row exceeds int32 indexing")


def _rows_nnz_error(set_bits: list, nnz: list, width: int) -> ValueError:
    return ValueError(f"the bitmaps hold {set_bits} set bits per row but nnz "
                      f"is {nnz} (values width {width})")


def _check_rows_nnz(set_bits: torch.Tensor, nnz: torch.Tensor,
                    width: int) -> None:
    """One read-back: every row's set bits equal its nnz, within width."""
    nnz = nnz.to(torch.int64)
    if bool(((set_bits != nnz) | (nnz > width)).any()):
        raise _rows_nnz_error(set_bits.tolist(), nnz.tolist(), width)


def packed_accum_rows(num: torch.Tensor, den: torch.Tensor,
                      words: torch.Tensor, values: torch.Tensor,
                      nnz: torch.Tensor, alpha: float = 1.0):
    """Fold payload k into row k of ``num``/``den`` (K, N) in place, for all
    K rows in one launch; returns them.  ``values`` is (K, max_nnz) fp32 or
    fp16 (widened exactly), row k's values left-aligned; ``nnz`` (K,) int32
    on the same device."""
    global LAUNCHES_ROWS
    _check_rows(num, den, words, values, nnz)
    if num.device.type == "cpu":
        return packed_accum_rows_plain(num, den, words, values, nnz, alpha)
    if num.device.type != "cuda":
        raise ValueError(f"unsupported device {num.device}")
    k, n = num.shape
    if n == 0 or k == 0:
        return num, den
    fold = build.function("packed_accum", _ROWS_ENTRY[values.dtype],
                          _ROWS_ARGTYPES)
    res = torch.empty(2 * k, dtype=torch.int32, device=num.device)
    offsets = torch.empty(k * -(-n // GROUP_N), dtype=torch.int32,
                          device=num.device)
    _scan(words, k, n, nnz, 0, values.shape[1], offsets.data_ptr(),
          res.data_ptr())
    res = res.tolist()
    if any(res[k:]):
        raise _rows_nnz_error(res[:k], nnz.tolist(), values.shape[1])
    build.check(build.launch(
        fold, num, num.data_ptr(), den.data_ptr(), words.data_ptr(),
        values.data_ptr(), offsets.data_ptr(), float(alpha), k, n,
        words.shape[1], values.shape[1]), "packed_accum_rows")
    LAUNCHES_ROWS += 1
    LAUNCHES_BY_ENTRY[_ROWS_ENTRY[values.dtype]] += 1
    return num, den
