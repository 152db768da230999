"""Checkpointing sparse message payloads: ``PackedSparse`` <-> plain arrays
(reference ``repro.checkpoint.packed``).

``checkpoint.npz`` stores trees of *arrays*; an in-flight simulator message
is a tree of ``PackedSparse`` leaves (bitmap words + nnz values + a static
dense shape).  ``encode_packed`` rewrites every ``PackedSparse`` into the
reference's marked plain dict (``{"__packed_sparse__": {"bitmap",
"values", "shape"}}``, the bitmap as uint32 words) so the tree survives the
flat-path .npz round trip; ``decode_packed`` is the exact inverse.  Bitmap
and values are stored verbatim — no re-quantization, no re-packing — so a
resumed simulation mixes bit-identical payloads, and a payload encoded by
either package decodes in the other.

Encoding copies device payloads to numpy; decoding puts them on the
device it is given.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.sparse.packed import (
    PackedSparse,
    is_packed,
    words_from_numpy,
    words_to_numpy,
)
from repro_torch.utils.tree import tree_map

PyTree = Any

_PACKED_KEY = "__packed_sparse__"


def encode_packed(tree: PyTree) -> PyTree:
    """Replace every ``PackedSparse`` leaf with a marked plain-array dict
    (checkpointable); other leaves pass through untouched."""

    def enc(x):
        if is_packed(x):
            return {_PACKED_KEY: {
                "bitmap": words_to_numpy(x.bitmap),
                "values": x.values.detach().cpu().numpy(),
                "shape": np.asarray(x.shape, dtype=np.int64),
            }}
        return x

    return tree_map(enc, tree, is_leaf=is_packed)


def _is_marker(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {_PACKED_KEY}


def decode_packed(tree: PyTree, device="cpu") -> PyTree:
    """Inverse of ``encode_packed`` (bitmap and values restored verbatim,
    on ``device``); other leaves pass through untouched."""

    def dec(x):
        if _is_marker(x):
            d = x[_PACKED_KEY]
            return PackedSparse(
                bitmap=words_from_numpy(np.asarray(d["bitmap"]), device),
                values=torch.tensor(np.asarray(d["values"]), device=device),
                shape=tuple(int(s) for s in np.asarray(d["shape"])))
        return x

    return tree_map(dec, tree, is_leaf=_is_marker)
