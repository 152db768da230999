"""``ModelStore`` — personalized models at wire density, served from a
device slot pool (reference ``repro.serve.store``).

Each user's model is held *exactly as it travels on the wire*: a
codec-encoded ``PackedSparse`` frame (``sparse/codec.py`` — 8-byte header +
bitmap + nnz values) against a shared dense base model.  The frame IS the
at-rest format, so

    store.bytes_at_rest(user) == codec.encoded_nbytes(user's packed delta)

byte for byte, and the frames equal the reference's for the same
``(params, mask)``.  Frame values are the user's weights at the mask
support (a replacement delta), so ``get(user)`` returns ``w ⊙ m``
bit-exactly.  Users without a frame are served the base with an all-ones
mask (cold start).

The LRU cache is a *slot pool*: one preallocated ``(cache_size, ...)``
tensor per leaf on the store's device, holding the unpacked dense-masked
models of the ``cache_size`` most recently served users.  The pool IS the
batched launch operand, so a hit moves zero parameter bytes.  A miss
decodes the user's frame on the host (``codec.decode_dense``) and writes
its slot in place (``pool[slot].copy_``); the pool is never rebuilt.  The
LRU order and the ``hits`` / ``misses`` / ``evictions`` counters follow the
reference's step for step.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs import CounterSet, SeriesSet, get_tracer, span
from repro_torch.sparse.codec import (
    TreeSpec,
    decode_dense,
    encode,
    encoded_nbytes,
)
from repro_torch.sparse.packed import pack_tree, tree_packed_nnz
from repro_torch.utils.tree import (
    tree_index,
    tree_leaves,
    tree_map,
    tree_ones_like,
    tree_unflatten_like,
)

PyTree = Any


class ModelStore:
    """Per-user packed personalized models + slot-pool LRU cache.

    ``base_params`` is the shared dense base (a tree of tensors): served,
    with an all-ones mask, to users without a stored delta, and the
    template the message schema (``TreeSpec``) is derived from.  Frames
    carry fp32 values.  The pool lives on ``device`` (default: the base's
    device).
    """

    def __init__(self, base_params: PyTree, cache_size: int = 32,
                 device=None):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.base = base_params
        self.cache_size = int(cache_size)
        self.device = torch.device(
            device if device is not None else tree_leaves(base_params)[0].device)
        self.spec = TreeSpec.from_tree(base_params, dtype=np.float32)
        self._frames: dict[int, bytes] = {}
        self._nnz: dict[int, int] = {}
        # slot pool: preallocated stacked device buffers; _slot_of is the LRU map
        c = self.cache_size
        self._pool = {
            "params": tree_map(
                lambda x: torch.zeros((c, *x.shape), dtype=x.dtype,
                                      device=self.device), base_params),
            "masks": tree_map(
                lambda x: torch.zeros((c, *x.shape), dtype=torch.float32,
                                      device=self.device), base_params),
        }
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()
        self._free = list(range(c - 1, -1, -1))     # pop() hands out 0,1,...
        self.obs = CounterSet("serve.store")
        self._c_hits = self.obs.counter("hits")
        self._c_misses = self.obs.counter("misses")
        self._c_evictions = self.obs.counter("evictions")
        self.obs.gauge("resident", fn=lambda: len(self._slot_of))
        self.obs.gauge("bytes_at_rest", fn=self.total_bytes_at_rest)
        # miss-path latency sketch: decode + slot-write seconds, the cost a
        # cache hit avoids entirely
        self.series = SeriesSet("serve.store")
        self._h_miss_s = self.series.histogram("miss_decode_s")
        # per-slot residency: an open wall-clock span per occupied slot
        self._slot_handles: dict[int, Any] = {}

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def put(self, user: int, params: PyTree, mask: Optional[PyTree]) -> int:
        """Encode ``params ⊙ mask`` as the user's at-rest frame; returns its
        size in bytes.  ``mask=None`` stores a dense (all-ones) delta."""
        packed = pack_tree(params, mask, dtype=torch.float32)
        frame = encode(packed)
        assert len(frame) == encoded_nbytes(packed)
        self._frames[user] = frame
        self._nnz[user] = tree_packed_nnz(packed)
        slot = self._slot_of.pop(user, None)        # stale unpacked copy
        if slot is not None:
            self._free.append(slot)
            self._end_residency(slot)
        return len(frame)

    # ------------------------------------------------------------------
    # read path (through the slot-pool LRU cache)
    # ------------------------------------------------------------------
    def _end_residency(self, slot: int) -> None:
        get_tracer().end(self._slot_handles.pop(slot, None))

    def _begin_residency(self, slot: int, user: int) -> None:
        tr = get_tracer()
        if tr.enabled:
            self._slot_handles[slot] = tr.begin(
                f"user:{user}", track=f"slot/{slot}", user=user)

    def _write(self, slot: int, entry: dict) -> None:
        """Copy one unpacked model into pool slot ``slot``, in place."""
        for key in ("params", "masks"):
            for buf, x in zip(tree_leaves(self._pool[key]),
                              tree_leaves(entry[key])):
                buf[slot].copy_(x)

    def acquire(self, user: int) -> int:
        """Slot index of the user's unpacked model, loading it into the
        pool on a miss (evicting the least recently served user if full).
        The returned slot stays valid until ``cache_size - 1`` further
        distinct-user acquires."""
        slot = self._slot_of.get(user)
        if slot is not None:
            self._c_hits.inc()
            self._slot_of.move_to_end(user)
            return slot
        self._c_misses.inc()
        t0 = time.perf_counter()
        with span("store.miss_decode", track="store", user=user) as sp:
            frame = self._frames.get(user)
            if frame is None:
                entry = {"params": self.base,
                         "masks": tree_ones_like(self.base)}
            else:
                # single-pass host decode: the serving hot path
                params, masks = decode_dense(frame, self.spec)
                entry = {"params": params, "masks": masks}
                sp.attrs["nbytes"] = len(frame)
            if self._free:
                slot = self._free.pop()
            else:
                _, slot = self._slot_of.popitem(last=False)
                self._c_evictions.inc()
            self._end_residency(slot)
            self._write(slot, entry)
            self._slot_of[user] = slot
            self._begin_residency(slot, user)
        self._h_miss_s.add(time.perf_counter() - t0)
        return slot

    def get(self, user: int) -> tuple[PyTree, PyTree]:
        """The user's unpacked (dense-masked params, mask) — bit-exact vs
        the training-side ``w ⊙ m``, as copies (a later miss may overwrite
        the slot).  Unknown users get the shared base with an all-ones
        mask (cold start)."""
        slot = self.acquire(user)
        return (tree_map(torch.clone, tree_index(self._pool["params"], slot)),
                tree_map(torch.clone, tree_index(self._pool["masks"], slot)))

    @property
    def pool_params(self) -> PyTree:
        """(cache_size, ...) stacked params — the batched launch operand."""
        return self._pool["params"]

    @property
    def pool_masks(self) -> PyTree:
        """(cache_size, ...) stacked masks, aligned with ``pool_params``."""
        return self._pool["masks"]

    def resident(self, user: int) -> bool:
        """True iff the user's unpacked model holds a pool slot right now
        (no counter side effects — the batcher's grouping predicate)."""
        return user in self._slot_of

    def __contains__(self, user: int) -> bool:
        return user in self._frames

    def users(self) -> list[int]:
        return sorted(self._frames)

    # cache counters (registry-backed; attribute API as the reference's)
    @property
    def hits(self) -> int:
        return int(self._c_hits.value)

    @property
    def misses(self) -> int:
        return int(self._c_misses.value)

    @property
    def evictions(self) -> int:
        return int(self._c_evictions.value)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def bytes_at_rest(self, user: int) -> int:
        """Exact at-rest size of the user's frame — equals
        ``codec.encoded_nbytes`` of their packed delta by construction."""
        return len(self._frames[user])

    def frame(self, user: int) -> bytes:
        """The user's at-rest codec frame."""
        return self._frames[user]

    def total_bytes_at_rest(self) -> int:
        return sum(len(f) for f in self._frames.values())

    def nnz(self, user: int) -> int:
        return self._nnz[user]

    def stats(self) -> dict:
        return {
            "users": len(self._frames),
            "cache_size": self.cache_size,
            "resident": len(self._slot_of),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "bytes_at_rest": self.total_bytes_at_rest(),
        }

    # ------------------------------------------------------------------
    # construction from training artifacts
    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str, cache_size: int = 32,
                        device="cuda") -> "ModelStore":
        """Load a trained engine archive (written by either package's
        ``RoundEngine.save``) into a store: client k's personalized params
        (⊙ mask, when the strategy keeps masks) become user k's delta.

        The base is the dense mean of the client models, taken in numpy as
        the reference takes it.  The pool lives on ``device`` (default:
        CUDA, which raises without a GPU; pass ``device="cpu"`` for the
        CPU)."""
        from repro_torch.checkpoint.npz import load_pytree, tree_from_numpy
        from repro_torch.device import setup_device
        from repro_torch.fl.engine import _unpack

        device = setup_device(device)

        payload = load_pytree(path)
        if "state" not in payload or "params" not in payload["state"]:
            raise ValueError(
                f"{path} is not an engine archive (no state/params)")
        state = _unpack(payload["state"])
        params = state["params"]
        masks = state.get("masks")
        stacked = [np.stack([np.asarray(x) for x in leaves])
                   for leaves in zip(*(tree_leaves(p) for p in params))]
        base_params = tree_from_numpy(tree_unflatten_like(
            params[0], [s.mean(axis=0) for s in stacked]), device)
        store = cls(base_params, cache_size=cache_size, device=device)
        for k, p in enumerate(params):
            # dispfl-style params are already w ⊙ m; pack gathers at the
            # mask's support, so the stored values are the trained weights
            store.put(k, tree_from_numpy(p),
                      tree_from_numpy(masks[k]) if masks is not None else None)
        return store
