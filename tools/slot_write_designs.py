"""Time the slot write designs the serving store does without, per miss.

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
(2 slots).  Needs a CUDA GPU:

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
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, model, slots, iters in (
            ("mlp", build_model("mlp", 4), 256, 200),
            ("gemma3-1b", ArchModel(ARCHS["gemma3-1b"], prompt_len=2048), 2,
             5)):
        store = ModelStore(model.init(gen), cache_size=slots)
        row = designs(torch, tree_leaves(store._pool), iters)
        print(json.dumps({"store": name, "slots": slots, "iters": iters,
                          **row}), flush=True)
        del store
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
