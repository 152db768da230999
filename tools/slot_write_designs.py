"""Time, per serving miss, the slot write designs the serving store does
without and the two designs of its frame check.

A cache miss of ``repro_torch.serve.ModelStore`` decodes the user's frame
straight into its pool slot, so no decoded tree is written afterwards.
The reference decodes into a fresh tree and writes it into the slot with a
buffer-donating jit.  This script times that write in the port's two
candidate forms, from a slot-sized entry buffer (slot 0's own contents, so
each write leaves the pool as it was):

* a compiled write (``utils.graph.graphed``: ``index_copy_`` at a device
  slot index, one replay), over 8-byte word views of each leaf and over
  the leaves in their own 4-byte dtype;
* a per-leaf ``pool[slot].copy_``.

For each: host microseconds a call (no synchronise), ms a call (CUDA
events) and host and device ms a call (a synchronise after each), at the
serving CLI's MLP store (256 slots) and at gemma3-1b's published width
(2 slots).

A miss checks its frame's bitmap against the header's value count before
it gives a slot up.  The two designs, each timed alone and as the whole
miss (check, then decode into the slot, a synchronise after each; one
user's frame at density 0.5):

* ``host popcount`` (the store's, ``codec.check_bitmap``): the frame's
  words read in place on the host, their set bits counted
  (``np.bitwise_count``) against the header, then ``codec.decode_dense``
  (words and values to the device, one read-back a leaf for its count);
* ``device scan``: the frame's words and values to the device, a popcount
  and prefix sum there, every leaf's count read back in one transfer
  before anything is written, then the same decode with those counts
  (no read-back a leaf for them).

Needs a CUDA GPU:

    PYTHONPATH=src python3 tools/slot_write_designs.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def designs(torch, pool, iters):
    from repro_torch.utils.graph import graphed

    def write(pool, slot, entry):
        index = slot.view(1)
        for buf, x in zip(pool, entry):
            buf.index_copy_(0, index, x.unsqueeze(0))

    def words(t, lead):
        flat = t.view(*lead, -1)
        return (flat.view(torch.int64)
                if flat.shape[-1] * flat.element_size() % 8 == 0 else flat)

    entry = [x[0].clone() for x in pool]
    slot = torch.zeros((), dtype=torch.int64, device=pool[0].device)
    cells = {"graphed 8-byte": ([words(x, (x.shape[0],)) for x in pool],
                                [words(x, ()) for x in entry]),
             "graphed 4-byte": (pool, entry)}
    fns, graphs = {}, []
    for name, (p, e) in cells.items():
        g = graphed(write, donate=(0, 1, 2))
        graphs.append(g)
        fns[name] = (lambda g=g, p=p, e=e: (slot.fill_(0), g(p, slot, e)))

    def per_leaf():
        for buf, x in zip(pool, entry):
            buf[0].copy_(x)

    fns["copy_"] = per_leaf
    out = {"leaves": len(pool),
           "slot_bytes": sum(x[0].numel() * x.element_size() for x in pool)}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        out[name] = dict(host_us=host_us, ms=a.elapsed_time(b) / iters,
                         sync_ms=(time.perf_counter() - t0) / iters * 1e3)
    if not all(torch.equal(b[0], x) for b, x in zip(pool, entry)):
        raise AssertionError("a slot write changed slot 0")
    for g in graphs:
        g.release()
    return out


def _popcount(x):
    """Set bits of each word of an int64 tensor holding uint32 words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _device_scan(torch, frame, spec, device):
    """The device design's check: (words, values, per-leaf counts), the
    words and values on ``device``, the counts read back in one transfer;
    raises on a bitmap that disagrees with the header."""
    import numpy as np

    from repro_torch.sparse.codec import _frame_words
    from repro_torch.sparse.packed import BITS_PER_WORD, words_from_numpy

    words, values, nnz = _frame_words(frame, spec)
    words = words_from_numpy(words, device)
    sizes = np.cumsum([0] + [int(np.prod(s)) for s in spec.shapes])
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    cum = torch.cumsum(torch.cat([w64.new_zeros(1), _popcount(w64)]), 0)
    bounds = torch.from_numpy(sizes).to(device)
    q, r = bounds // BITS_PER_WORD, bounds % BITS_PER_WORD
    part = w64[q.clamp(max=w64.numel() - 1)] & ((1 << r) - 1)
    prefix = cum[q] + _popcount(part)
    counts = (prefix[1:] - prefix[:-1]).tolist()
    if sum(counts) != nnz:
        raise ValueError(f"frame carries {nnz} values, schema holds "
                         f"{sum(counts)}")
    return words, torch.from_numpy(values).to(device), counts


def _scanned_decode(torch, scanned, spec, out):
    """``codec.decode_dense`` into ``out`` from the device scan's words,
    values and per-leaf counts."""
    import numpy as np

    from repro_torch.sparse.packed import BITS_PER_WORD, n_words, unpack_bits
    from repro_torch.utils.tree import tree_leaves

    words, values, counts = scanned
    into = [tree_leaves(t) for t in out]
    pos = vpos = 0
    for i, shape in enumerate(spec.shapes):
        n = int(np.prod(shape))
        w0, w1 = pos // BITS_PER_WORD, n_words(pos + n)
        lo = pos - w0 * BITS_PER_WORD
        flags = unpack_bits(words[w0:w1], lo + n)[lo:]
        dense = into[0][i].view(-1).zero_()
        into[1][i].view(-1).copy_(flags)
        dense[flags] = values[vpos:vpos + counts[i]].to(dense.dtype)
        pos += n
        vpos += counts[i]


def check_designs(torch, store, user, iters):
    """The two frame-check designs, alone and as a whole miss into slot
    0, ms a call with a synchronise after each (two passes each, A, B, B,
    A); both misses must leave slot 0 bit-equal."""
    from repro_torch.sparse.codec import check_bitmap, decode_dense
    from repro_torch.utils.tree import tree_index, tree_leaves

    frame, spec, dev = store.frame(user), store.spec, store.device
    slot = tuple(tree_index(store._pool[k], 0) for k in ("params", "masks"))
    fns = {
        "host popcount": lambda: check_bitmap(frame, spec),
        "device scan": lambda: _device_scan(torch, frame, spec, dev),
        "host popcount miss": lambda: (
            check_bitmap(frame, spec),
            decode_dense(frame, spec, device=dev, out=slot)),
        "device scan miss": lambda: _scanned_decode(
            torch, _device_scan(torch, frame, spec, dev), spec, slot),
    }
    out, pools = {}, {}
    # each design twice, in the order A, B, B, A, so neither gains from
    # going second
    order = ["host popcount", "device scan", "device scan", "host popcount",
             "host popcount miss", "device scan miss", "device scan miss",
             "host popcount miss"]
    for name in order:
        fn = fns[name]
        fn()
        torch.cuda.synchronize()
        if name.endswith("miss"):
            pools[name] = [x.clone() for x in tree_leaves(slot)]
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        out.setdefault(name, {"sync_ms": []})["sync_ms"].append(
            (time.perf_counter() - t0) / iters * 1e3)
    a, b = pools.values()
    if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b)):
        raise AssertionError("the two misses decoded different slots")
    return {"frame_bytes": len(frame), "words": (spec.n_coords + 31) // 32,
            **out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import ArchModel, ModelStore
    from repro_torch.utils.tree import tree_leaves

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(card)
    from repro_torch.core.masks import apply_mask, init_mask

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, model, slots, iters in (
            ("mlp", build_model("mlp", 4), 256, 200),
            ("gemma3-1b", ArchModel(ARCHS["gemma3-1b"], prompt_len=2048), 2,
             5)):
        store = ModelStore(model.init(gen), cache_size=slots)
        row = designs(torch, tree_leaves(store._pool), iters)
        print(json.dumps({"store": name, "slots": slots, "iters": iters,
                          **row}), flush=True)
        p = model.init(gen)
        m = init_mask(gen, p, 0.5)
        store.put(0, apply_mask(p, m), m)
        del p, m
        row = check_designs(torch, store, 0, iters)
        print(json.dumps({"store": name, "frame_check": True,
                          "iters": iters, **row}), flush=True)
        del store
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
