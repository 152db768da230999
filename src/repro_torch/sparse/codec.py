"""Deterministic wire serialization for packed sparse messages (reference
``repro.sparse.codec``; frames are byte-identical to the reference's for
the same state).

Frame layout (little-endian throughout)::

    [magic u16][version u8][dtype u8][nnz u32]     8-byte header
    [bitmap: ceil(n_coords / 32) uint32 words]     mask over the
                                                   *concatenated* leaf
                                                   coordinate space
    [values: nnz * itemsize bytes]                 held values, leaf order

Both endpoints share the model architecture, so leaf shapes / dtypes /
tree structure travel once as a ``TreeSpec`` (negotiated out of band, like
a schema), never per message.  Leaf bit-streams are concatenated *without*
inter-leaf padding: the frame size is therefore an exact function of
``(nnz, n_coords, itemsize)``, which is what lets ``core.accounting`` quote
the same number analytically —

    encoded_nbytes(packed) == accounting.message_bytes(
        nnz, n_coords, with_bitmap=True, value_nbytes=itemsize)

Frames are host bytes, so encoding reads each leaf's bitmap and values back
to the host once; the bit work is numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np
import torch

from repro_torch.core.accounting import HEADER_NBYTES, bitmap_nbytes
from repro_torch.obs import CounterSet, span
from repro_torch.sparse.packed import (
    BITS_PER_WORD,
    PackedSparse,
    is_packed,
    n_words,
    words_from_numpy,
    words_to_numpy,
)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

PyTree = Any

# wire-format observability: frame counts and exact byte totals
OBS = CounterSet("sparse.codec")
_C_ENCODES = OBS.counter("encodes")
_C_BYTES_OUT = OBS.counter("bytes_out")
_C_DECODES = OBS.counter("decodes")
_C_DENSE_DECODES = OBS.counter("dense_decodes")
_C_BYTES_IN = OBS.counter("bytes_in")

MAGIC = 0x5350            # "SP"
VERSION = 1
_HEADER = struct.Struct("<HBBI")
assert _HEADER.size == HEADER_NBYTES

_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def _pack_bits(flags: np.ndarray) -> np.ndarray:
    """Bool (n,) -> uint32 words (n_words,), little-endian bit order."""
    flags = np.asarray(flags, dtype=bool).reshape(-1)
    pad = (-flags.size) % BITS_PER_WORD
    if pad:
        flags = np.concatenate([flags, np.zeros(pad, dtype=bool)])
    words = flags.reshape(-1, BITS_PER_WORD).astype(np.uint32)
    shifts = np.arange(BITS_PER_WORD, dtype=np.uint32)
    return (words << shifts).sum(axis=1, dtype=np.uint32)


def _unpack_bits(words: np.ndarray, n_coords: int) -> np.ndarray:
    """uint32 words -> bool (n_coords,), inverse of ``_pack_bits``."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(BITS_PER_WORD, dtype=np.uint32)
    bits = (words[:, None] >> shifts) & np.uint32(1)
    return bits.reshape(-1)[:n_coords].astype(bool)


def _np_values(p: PackedSparse) -> np.ndarray:
    return p.values.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """The out-of-band message schema: tree structure + leaf shapes/dtype.

    ``treedef`` is the tree's structure with a placeholder at every leaf
    (the port has no pytree registry)."""

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtype: np.dtype

    @classmethod
    def from_tree(cls, tree: PyTree, dtype=np.float32) -> "TreeSpec":
        """Build from a template — dense params or an already-packed tree."""
        leaves = tree_leaves(tree, is_leaf=is_packed)
        if leaves and isinstance(leaves[0], PackedSparse):
            shapes = tuple(p.shape for p in leaves)
            dtype = _np_values(leaves[0]).dtype
        else:
            shapes = tuple(tuple(x.shape) for x in leaves)
        treedef = tree_map(lambda _: 0, tree, is_leaf=is_packed)
        return cls(treedef=treedef, shapes=shapes, dtype=np.dtype(dtype))

    @property
    def n_coords(self) -> int:
        return sum(int(np.prod(s)) for s in self.shapes)

    def unflatten(self, leaves) -> PyTree:
        return tree_unflatten_like(self.treedef, leaves)


def _leaves(packed: PyTree) -> list[PackedSparse]:
    leaves = tree_leaves(packed, is_leaf=is_packed)
    for p in leaves:
        if not isinstance(p, PackedSparse):
            raise TypeError(f"expected a tree of PackedSparse, got {type(p)}")
    return leaves


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def encoded_nbytes(packed: PyTree) -> int:
    """Exact frame size of ``encode(packed)`` — header + word-aligned
    bitmap over the concatenated coordinates + value bytes."""
    leaves = _leaves(packed)
    nnz = sum(p.nnz for p in leaves)
    n_coords = sum(p.n_coords for p in leaves)
    # metadata only — never reads device values
    itemsize = _itemsize(leaves[0].values.dtype) if leaves else 4
    return HEADER_NBYTES + bitmap_nbytes(n_coords) + itemsize * nnz


def encode(packed: PyTree) -> bytes:
    """Serialize a packed tree to one wire frame (little-endian)."""
    with span("codec.encode", track="codec") as sp:
        leaves = _leaves(packed)
        host_values = [_np_values(p) for p in leaves]
        dtype = host_values[0].dtype
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported wire dtype {dtype}")
        if any(v.dtype != dtype for v in host_values):
            raise ValueError(
                "all leaves of one message must share a value dtype")
        # concatenate leaf bit-streams with no inter-leaf padding, repack
        flags = np.concatenate(
            [_unpack_bits(words_to_numpy(p.bitmap), p.n_coords)
             for p in leaves]
        ) if leaves else np.zeros(0, dtype=bool)
        words = _pack_bits(flags)
        values = (np.concatenate(host_values) if leaves
                  else np.zeros(0, dtype))
        nnz = int(values.size)
        out = b"".join([
            _HEADER.pack(MAGIC, VERSION, _DTYPE_CODES[dtype], nnz),
            words.astype("<u4").tobytes(),
            values.astype(values.dtype.newbyteorder("<")).tobytes(),
        ])
        assert len(out) == encoded_nbytes(packed)
        sp.attrs["nbytes"] = len(out)
        _C_ENCODES.inc()
        _C_BYTES_OUT.inc(len(out))
    return out


def _frame_arrays(data: bytes, spec: TreeSpec):
    """Parse one frame's header and pull out (flags, values, nnz) as host
    arrays — the shared prelude of ``decode`` / ``decode_dense``."""
    magic, version, code, nnz = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:04x}")
    if version != VERSION:
        raise ValueError(f"unsupported codec version {version}")
    dtype = _CODE_DTYPES[code]
    n_coords = spec.n_coords
    off = HEADER_NBYTES
    nb_bitmap = bitmap_nbytes(n_coords)
    words = np.frombuffer(data, dtype="<u4", count=n_words(n_coords),
                          offset=off).astype(np.uint32)
    values = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"),
                           count=nnz, offset=off + nb_bitmap).astype(dtype)
    flags = _unpack_bits(words, n_coords)
    return flags, values, nnz


def decode(data: bytes, spec: TreeSpec) -> PyTree:
    """Rebuild the packed tree (CPU tensors) from one frame + its
    out-of-band schema."""
    with span("codec.decode", track="codec", nbytes=len(data)):
        _C_DECODES.inc()
        _C_BYTES_IN.inc(len(data))
        flags, values, nnz = _frame_arrays(data, spec)
        leaves, pos, vpos = [], 0, 0
        for shape in spec.shapes:
            n = int(np.prod(shape))
            leaf_flags = flags[pos:pos + n]
            k = int(leaf_flags.sum())
            leaves.append(PackedSparse(
                bitmap=words_from_numpy(_pack_bits(leaf_flags)),
                values=torch.from_numpy(values[vpos:vpos + k].copy()),
                shape=tuple(shape)))
            pos += n
            vpos += k
        if vpos != nnz:
            raise ValueError(
                f"frame carries {nnz} values, schema holds {vpos}")
        return spec.unflatten(leaves)


def decode_dense(data: bytes, spec: TreeSpec, mask_dtype=torch.float32,
                 device="cpu") -> tuple[PyTree, PyTree]:
    """Decode one frame straight to dense leaves: ``(params, masks)`` trees
    of tensors on ``device``, bit-exact vs ``unpack_tree(decode(...))``.

    This is the serving hot path (a cache miss stands between a request
    and its launch): one bit-unpack pass over the whole frame on the host,
    one scatter per leaf, and no intermediate ``PackedSparse``.
    """
    with span("codec.decode_dense", track="codec", nbytes=len(data)):
        _C_DENSE_DECODES.inc()
        _C_BYTES_IN.inc(len(data))
        flags, values, nnz = _frame_arrays(data, spec)
        params, masks, pos, vpos = [], [], 0, 0
        for shape in spec.shapes:
            n = int(np.prod(shape))
            leaf_flags = flags[pos:pos + n]
            k = int(leaf_flags.sum())
            dense = np.zeros(n, dtype=values.dtype)
            dense[leaf_flags] = values[vpos:vpos + k]
            params.append(torch.from_numpy(dense.reshape(shape)).to(device))
            masks.append(torch.from_numpy(leaf_flags.reshape(shape)).to(
                device=device, dtype=mask_dtype))
            pos += n
            vpos += k
        if vpos != nnz:
            raise ValueError(
                f"frame carries {nnz} values, schema holds {vpos}")
        return spec.unflatten(params), spec.unflatten(masks)
