"""``PackedSparse`` — the physical form of a DisPFL message, on the device
(reference ``repro.sparse.packed``).

One leaf travels as a bitmap (bit ``i % 32`` of word ``i // 32`` is
coordinate ``i`` of the row-major flattened leaf) plus the ``nnz`` held
values in coordinate order.  The words are the reference's ``uint32`` words;
``torch.uint32`` supports almost no arithmetic, so they are held as int32
tensors with the same bits and converted by ``.view`` at the archive/codec
boundary (``words_to_numpy``/``words_from_numpy``).

``unpack(pack(w, m)) == w ⊙ m`` exactly: values are gathered, never
re-quantized.  Packing has a data-dependent size, so it reads the nnz back
from the device once per leaf.

Tree packs and unpacks are counted in the ``sparse.packed`` counter set
(``tree_packs``, ``tree_unpacks``) and traced as ``codec.pack_tree`` /
``codec.unpack_tree`` spans, as in the reference; ``sparse.ops.decode_tree``,
the barrier mix's unpack, counts as an unpack too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs import CounterSet, span
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

# message-boundary observability (pack/unpack happen per gossip payload)
OBS = CounterSet("sparse.packed")
_C_PACKS = OBS.counter("tree_packs")
_C_UNPACKS = OBS.counter("tree_unpacks")

BITS_PER_WORD = 32


def n_words(n_coords: int) -> int:
    """32-bit words needed to hold a bitmap over ``n_coords`` coordinates."""
    return (n_coords + BITS_PER_WORD - 1) // BITS_PER_WORD


@dataclasses.dataclass
class PackedSparse:
    """One packed leaf: bitmap words + contiguous nnz values."""

    bitmap: torch.Tensor       # (n_words,) int32 holding uint32 bits
    values: torch.Tensor       # (nnz,) float32 or float16
    shape: tuple[int, ...]

    @property
    def n_coords(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def pack_bits_rows(flags: torch.Tensor) -> torch.Tensor:
    """Bool (K, n) -> int32 words (K, n_words(n)), each row packed
    little-endian on its own (rows padded with zeros to whole words).

    Bits are packed into bytes (bit j of byte b is coordinate 8b + j) and
    four bytes are read as one little-endian word, so the transient is two
    bytes per coordinate."""
    k, n = flags.shape
    pad = (-n) % BITS_PER_WORD
    if pad:
        flags = torch.cat([flags, flags.new_zeros((k, pad))], dim=1)
    shifts = torch.arange(8, dtype=torch.uint8, device=flags.device)
    bits = flags.reshape(k, -1, 8).to(torch.uint8) << shifts
    packed = bits.sum(dim=2, dtype=torch.uint8)              # distinct bits
    return packed.view(torch.int32)


def unpack_bits_rows(words: torch.Tensor, n_coords: int) -> torch.Tensor:
    """Int32 words (K, n_words) -> bool (K, n_coords), inverse of
    ``pack_bits_rows``.  The shift is arithmetic on int32, which leaves bit
    ``j`` of the word in bit 0 of ``word >> j`` for every j < 32."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32,
                          device=words.device)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n_coords].bool()


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """Bool (n,) -> int32 words (n_words,), little-endian bit order."""
    return pack_bits_rows(flags.reshape(1, -1))[0]


def unpack_bits(words: torch.Tensor, n_coords: int) -> torch.Tensor:
    """Int32 words -> bool (n_coords,), inverse of ``pack_bits``."""
    return unpack_bits_rows(words.reshape(1, -1), n_coords)[0]


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The reference's uint32 words, bit for bit."""
    return words.detach().cpu().numpy().view(np.uint32)


def words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def pack(dense: torch.Tensor, mask: Optional[torch.Tensor] = None,
         dtype: Optional[torch.dtype] = None) -> PackedSparse:
    """Pack one leaf.  ``mask=None`` means dense (all-ones bitmap)."""
    flat = dense.reshape(-1)
    if mask is None:
        flags = torch.ones(flat.numel(), dtype=torch.bool, device=flat.device)
    else:
        flags = mask.reshape(-1) != 0
    vals = flat[flags]
    if dtype is not None:
        vals = vals.to(dtype)
    return PackedSparse(bitmap=pack_bits(flags), values=vals,
                        shape=tuple(dense.shape))


def unpack(ps: PackedSparse) -> torch.Tensor:
    """Dense leaf: held values at their coordinates, exact zeros elsewhere."""
    flags = unpack_bits(ps.bitmap, ps.n_coords)
    out = torch.zeros(ps.n_coords, dtype=ps.values.dtype,
                      device=ps.values.device)
    out[flags] = ps.values
    return out.reshape(ps.shape)


def unpack_mask(ps: PackedSparse, dtype=torch.float32) -> torch.Tensor:
    """The {0,1} mask implied by the bitmap (dense leaf shape)."""
    return unpack_bits(ps.bitmap, ps.n_coords).to(dtype).reshape(ps.shape)


def is_packed(x) -> bool:
    return isinstance(x, PackedSparse)


def pack_tree(params: PyTree, masks: Optional[PyTree] = None,
              dtype: Optional[torch.dtype] = None) -> PyTree:
    """Pack every leaf of a parameter tree (``masks=None`` -> dense)."""
    with span("codec.pack_tree", track="codec"):
        _C_PACKS.inc()
        if masks is None:
            return tree_map(lambda w: pack(w, None, dtype), params)
        return tree_map(lambda w, m: pack(w, m, dtype), params, masks)


def unpack_tree(packed: PyTree) -> PyTree:
    """Dense parameter tree from a packed one."""
    with span("codec.unpack_tree", track="codec"):
        _C_UNPACKS.inc()
        return tree_map(unpack, packed, is_leaf=is_packed)


def unpack_mask_tree(packed: PyTree, dtype=torch.float32) -> PyTree:
    return tree_map(lambda p: unpack_mask(p, dtype), packed, is_leaf=is_packed)


def tree_packed_nnz(packed: PyTree) -> int:
    """Total transmitted values across a packed tree."""
    return sum(p.nnz for p in tree_leaves(packed, is_leaf=is_packed))
