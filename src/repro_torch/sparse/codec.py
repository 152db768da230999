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
to the host once and joins the leaf bitmaps word by word (a shift per
leaf, never a pass per bit).  ``decode_dense`` unpacks on the device it
decodes to, so a serving miss moves the frame's bytes once and scatters
there; ``check_bitmap`` refuses, on the host and before anything is
written, a frame whose bitmap disagrees with its header.
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
    unpack_bits,
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


def _concat_bitmaps(parts) -> np.ndarray:
    """Join per-leaf bitmaps ``[(uint32 words, n_coords), ...]`` into one
    little-endian bit stream with no padding between leaves: leaf bits
    start at the running coordinate offset, so a leaf at an offset that is
    not a multiple of 32 is shifted into place word by word."""
    total = sum(n for _, n in parts)
    out = np.zeros(n_words(total), dtype=np.uint32)
    off = 0
    for words, n in parts:
        w = np.array(words[:n_words(n)], dtype=np.uint32)
        if n % BITS_PER_WORD:          # clear any bits past the leaf's end
            w[-1] &= np.uint32((1 << (n % BITS_PER_WORD)) - 1)
        q, r = divmod(off, BITS_PER_WORD)
        if r == 0:
            out[q:q + w.size] |= w
        else:
            out[q:q + w.size] |= w << np.uint32(r)
            hi = w >> np.uint32(BITS_PER_WORD - r)
            end = min(q + 1 + w.size, out.size)
            out[q + 1:end] |= hi[:end - q - 1]
        off += n
    return out


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
        # concatenate leaf bit-streams with no inter-leaf padding
        words = _concat_bitmaps([(words_to_numpy(p.bitmap), p.n_coords)
                                 for p in leaves])
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


def check_frame(data: bytes, spec: TreeSpec) -> tuple[Any, int]:
    """(value dtype, nnz) of one frame, after checking its header and that
    it holds every byte a decode over ``spec`` reads.  What it cannot
    see without unpacking the bitmap: whether the bitmap holds ``nnz``
    bits (a decode raises where it does not)."""
    if len(data) < HEADER_NBYTES:
        raise ValueError(f"frame of {len(data)} bytes has no header")
    magic, version, code, nnz = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:04x}")
    if version != VERSION:
        raise ValueError(f"unsupported codec version {version}")
    dtype = _CODE_DTYPES[code]
    need = (HEADER_NBYTES + bitmap_nbytes(spec.n_coords)
            + np.dtype(dtype).itemsize * nnz)
    if len(data) < need:
        raise ValueError(f"frame holds {len(data)} bytes, its header and "
                         f"schema need {need}")
    return dtype, nnz


def check_bitmap(data: bytes, spec: TreeSpec) -> int:
    """The header's nnz, after ``check_frame`` and after counting the
    bitmap's set bits over the schema's coordinates against it (a host
    popcount of the frame's words, read in place, no copy): a frame that
    passes decodes.  A serving store runs it before it gives a slot up."""
    _, nnz = check_frame(data, spec)
    n = spec.n_coords
    words = np.frombuffer(data, dtype="<u4", count=n_words(n),
                          offset=HEADER_NBYTES)
    held = int(np.bitwise_count(words).sum(dtype=np.int64))
    tail = n % BITS_PER_WORD
    if tail:                     # bits past the last coordinate
        held -= int(np.bitwise_count(words[-1] >> np.uint32(tail)))
    if held != nnz:
        raise ValueError(f"frame carries {nnz} values, schema holds {held}")
    return nnz


def _frame_words(data: bytes, spec: TreeSpec):
    """Parse one frame's header and pull out (bitmap words, values, nnz) as
    host arrays — the shared prelude of ``decode`` / ``decode_dense``."""
    dtype, nnz = check_frame(data, spec)
    n_coords = spec.n_coords
    off = HEADER_NBYTES
    nb_bitmap = bitmap_nbytes(n_coords)
    words = np.frombuffer(data, dtype="<u4", count=n_words(n_coords),
                          offset=off).astype(np.uint32)
    values = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"),
                           count=nnz, offset=off + nb_bitmap).astype(dtype)
    return words, values, nnz


def decode(data: bytes, spec: TreeSpec) -> PyTree:
    """Rebuild the packed tree (CPU tensors) from one frame + its
    out-of-band schema."""
    with span("codec.decode", track="codec", nbytes=len(data)):
        _C_DECODES.inc()
        _C_BYTES_IN.inc(len(data))
        words, values, nnz = _frame_words(data, spec)
        flags = _unpack_bits(words, spec.n_coords)
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
                 device="cpu", out=None) -> tuple[PyTree, PyTree]:
    """Decode one frame straight to dense leaves: ``(params, masks)`` trees
    of tensors on ``device``, bit-exact vs ``unpack_tree(decode(...))``.
    With ``out``, a ``(params, masks)`` pair of trees of the schema's
    shapes (contiguous, on ``device``), the frame is decoded into those
    tensors in place, and ``out`` is returned.

    This is the serving hot path (a cache miss stands between a request
    and its launch): the frame's words and values go to ``device`` once,
    and each leaf is unpacked from the words that hold its bits and
    scattered there — no intermediate ``PackedSparse``, no host pass per
    bit.
    """
    with span("codec.decode_dense", track="codec", nbytes=len(data)):
        _C_DENSE_DECODES.inc()
        _C_BYTES_IN.inc(len(data))
        words, values, nnz = _frame_words(data, spec)
        words = words_from_numpy(words, device)
        values = torch.from_numpy(values).to(device)
        into = None if out is None else [tree_leaves(t) for t in out]
        params, masks, pos, vpos = [], [], 0, 0
        for i, shape in enumerate(spec.shapes):
            n = int(np.prod(shape))
            w0, w1 = pos // BITS_PER_WORD, n_words(pos + n)
            lo = pos - w0 * BITS_PER_WORD
            flags = unpack_bits(words[w0:w1], lo + n)[lo:]
            k = int(flags.sum())
            if into is None:
                dense = torch.zeros(n, dtype=values.dtype, device=device)
                params.append(dense.reshape(shape))
                masks.append(flags.reshape(shape).to(mask_dtype))
            else:
                dense = into[0][i].view(-1).zero_()
                into[1][i].view(-1).copy_(flags)
            dense[flags] = values[vpos:vpos + k].to(dense.dtype)
            pos += n
            vpos += k
        if vpos != nnz:
            raise ValueError(
                f"frame carries {nnz} values, schema holds {vpos}")
        if out is not None:
            return out
        return spec.unflatten(params), spec.unflatten(masks)
