"""The serving path compiled (``repro_torch.serve`` through
``utils.graph.graphed``), on the CPU.

* ``graph.check_capturable()`` over every serving body: the MLP's pool-wide
  forward on each backend (``vmap``, ``ref``, ``kernel``: on CPU tensors
  the kernel wrapper runs its plain version), smallcnn's vmapped forward
  and one smoke arch per family (dense, MoE, SSM, hybrid, VLM,
  encoder-decoder) vmapped over 2 users at 4-token prompts.  A host read,
  a data-dependent shape or a tensor built from host data in any of them
  raises ``CaptureError``.
* Each model's compiled forward donates the pool's params and masks,
  never the request inputs: the tensors a capture would take as
  its static inputs are the store's own pool tensors and a copy of the
  inputs (a model whose output has its input's shape would otherwise get
  its output written back into the input).
* Serving through ``ServeEngine`` under ``graph.disabled()`` and without it
  gives equal outputs and cache counters; a miss decodes straight into
  its slot, held once (no decoded copy of a leaf is made), each slot
  equal to the user's decoded model bit for bit (fp32 and fp16 frames, a
  planted -0.0 kept), and the engine's ``warmup()`` changes no slot and
  no counter.  A frame that fails to decode (cut short, or a bitmap that
  disagrees with its value count) raises before the store changes, as
  the reference's store leaves it.

The card's side (captures taken in ``warmup()``, replays bit-equal to
eager, launch counts, the pool read in place) is in
``tests/test_torch_cuda.py``.  Only the failed-decode test imports jax
(the reference's store).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core.accounting import HEADER_NBYTES
from repro_torch.core.masks import apply_mask, init_mask
from repro_torch.fl.base import make_cnn_task
from repro_torch.serve import (
    ArchModel,
    MLPModel,
    ModelStore,
    RequestStream,
    ServeEngine,
    TaskModel,
)
from repro_torch.sparse import ops
from repro_torch.sparse.codec import decode, decode_dense
from repro_torch.sparse.packed import is_packed
from repro_torch.utils import graph
from repro_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.tier1

# one smoke arch per family: dense, MoE, SSM, hybrid (attention, Mamba and
# MoE layers), VLM (patch prefix), encoder-decoder (audio frames)
FAMILY_ARCHS = ["gemma3-1b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                "jamba-1.5-large-398b", "llava-next-mistral-7b",
                "seamless-m4t-large-v2"]
USERS, PROMPT = 2, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: under the suite's parallel workers torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name):
    if name == "mlp":
        return MLPModel(d_in=16, widths=(24, 24), n_out=8, rows=2)
    if name == "smallcnn":
        return TaskModel(make_cnn_task("smallcnn", 10, 8, width=4,
                                       device="cpu"), hw=8, rows=1)
    return ArchModel(SMOKE_ARCHS[name], prompt_len=PROMPT)


def _store(model, users=4, cache=USERS, seed=0, payload=np.float32):
    store = ModelStore(model.init(torch.Generator().manual_seed(seed)),
                       cache_size=cache, payload_dtype=payload)
    gen = torch.Generator().manual_seed(seed + 1)
    for u in range(users):
        p = model.init(gen)
        m = init_mask(gen, p, 0.5)
        store.put(u, apply_mask(p, m), m)
    return store


def _pool_inputs(model, store):
    """Every slot filled (one user each) and a pool-wide input batch."""
    for u in range(store.cache_size):
        store.acquire(u)
    xs = torch.from_numpy(np.stack([model.make_input(u)
                                    for u in range(store.cache_size)]))
    return store.pool_params, store.pool_masks, xs


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# every serving body passes the capture check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["vmap", "ref", "kernel"])
def test_mlp_forward_is_capturable(backend):
    model = _model("mlp")
    ps, ms, xs = _pool_inputs(model, _store(model))
    with graph.check_capturable():
        y = model.batched_forward(ps, ms, xs, backend=backend)
    assert y.shape == (USERS, model.rows, model.dims[-1])
    want = torch.func.vmap(model.forward)(ps, xs)
    assert torch.allclose(y, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["smallcnn"] + FAMILY_ARCHS)
def test_vmapped_forward_is_capturable(name):
    model = _model(name)
    ps, ms, xs = _pool_inputs(model, _store(model))
    with graph.check_capturable():
        y = model.batched_forward(ps, ms, xs)
    want = torch.stack([model.forward(tree_map(lambda x: x[u], ps), xs[u])
                        for u in range(USERS)])
    assert y.shape == want.shape and bool(torch.isfinite(y).all())
    scale = max(1.0, float(want.abs().max()))
    assert float((y - want).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the pool is donated, the inputs are not
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,backend", [("mlp", "vmap"), ("mlp", "ref"),
                                          ("mlp", "kernel"),
                                          ("smallcnn", "vmap"),
                                          ("gemma3-1b", "vmap")])
def test_forward_donates_the_pool_not_the_input(name, backend):
    model = _model(name)
    store = _store(model)
    ps, ms, xs = _pool_inputs(model, store)
    model.batched_forward(ps, ms, xs, backend=backend)
    (g,) = model.graphs()
    args = (ps, ms, xs) if name == "mlp" else (ps, xs)
    pool = tree_leaves(ps) + (tree_leaves(ms) if name == "mlp" else [])
    x_at = len(args) - 1
    assert set(g.donate) == set(range(x_at))
    leaves, _ = graph._leaves(args)
    static = g._static_inputs(args, leaves)
    held = {id(x) for x in pool}
    assert sum(id(s) in held for s in static) == len(pool)
    (x_static,) = [s for s, x in zip(static, leaves) if x is xs]
    assert x_static is not xs and torch.equal(x_static, xs)


def test_mlp_with_equal_in_and_out_widths_keeps_its_input():
    """d_in == n_out: the output has the input's shape and dtype, and the
    input, not donated, is never written back."""
    model = MLPModel(d_in=8, widths=(12,), n_out=8, rows=2)
    store = _store(model)
    ps, ms, xs = _pool_inputs(model, store)
    before = xs.clone()
    for backend in model.backends():
        y = model.batched_forward(ps, ms, xs, backend=backend)
        assert y.shape == xs.shape and not torch.equal(y, xs)
        assert torch.equal(xs, before)


def test_one_compiled_forward_per_backend():
    model = _model("mlp")
    ps, ms, xs = _pool_inputs(model, _store(model))
    for backend in ("vmap", "kernel", "vmap", "ref", "kernel"):
        model.batched_forward(ps, ms, xs, backend=backend)
    assert sorted(model._jfwd) == ["kernel", "ref", "vmap"]
    assert len(model.graphs()) == 3
    with pytest.raises(ValueError, match="backend"):
        model.batched_forward(ps, ms, xs, backend="pallas")
    cnn = _model("smallcnn")
    with pytest.raises(ValueError, match="only the vmap backend"):
        cnn.batched_forward(ps, ms, xs, backend="kernel")
    assert cnn.graphs() == []


# ---------------------------------------------------------------------------
# serving, compiled and under graph.disabled()
# ---------------------------------------------------------------------------


def _serve(name, backend, eager):
    model = _model(name)
    store = _store(model, users=6, cache=3)
    engine = ServeEngine(store, model, backend=backend, max_batch=3)
    reqs = RequestStream(n_users=6, n_requests=16, seed=3).requests()
    if eager:
        with graph.disabled():
            return engine.serve(reqs), store
    return engine.serve(reqs), store


@pytest.mark.parametrize("name,backend", [
    ("mlp", "vmap"), ("mlp", "ref"), ("mlp", "kernel"), ("smallcnn", "vmap"),
    ("qwen3-moe-30b-a3b", "vmap")])
def test_serving_equals_under_graph_disabled(name, backend):
    (res_g, st_g), (res_e, st_e) = (_serve(name, backend, eager)
                                    for eager in (False, True))
    assert sorted(res_g.outputs) == sorted(res_e.outputs)
    for rid, y in res_g.outputs.items():
        assert y.dtype == res_e.outputs[rid].dtype
        assert np.array_equal(y, res_e.outputs[rid])
    assert st_g.stats() == st_e.stats() and st_g.misses > st_g.cache_size
    assert st_g.evictions > 0
    keys = ("requests", "batches", "cache_hit_rate", "store_hits",
            "store_misses", "store_evictions")
    assert ({k: res_g.summary[k] for k in keys}
            == {k: res_e.summary[k] for k in keys})
    assert _equal(st_g._pool, st_e._pool)


@pytest.mark.parametrize("payload", [np.float32, np.float16])
def test_miss_decodes_each_slot_its_model(payload):
    """Every slot, after misses, evictions and a cold-start user, holds
    the user's decoded ``(w ⊙ m, m)`` bit for bit, a planted -0.0 kept:
    the fp32 frame's ``decode_dense``, the fp16 frame's folds
    (``sparse.ops.decode``), the base with ones for a user with no frame."""
    model = _model("mlp")
    store = _store(model, users=5, cache=2, payload=payload)
    p = tree_map(torch.clone, store.base)
    tree_leaves(p)[0][0, 0] = -0.0
    m = tree_map(torch.ones_like, p)
    store.put(5, p, m)
    for user in (0, 1, 2, 5, 0, 9, 3):
        slot = store.acquire(user)
        got_p = tree_map(lambda x: x[slot], store.pool_params)
        got_m = tree_map(lambda x: x[slot], store.pool_masks)
        if user == 9:
            want = store.base, tree_map(torch.ones_like, store.base)
        elif payload == np.float32:
            want = decode_dense(store.frame(user), store.spec)
        else:
            pairs = [ops.decode(ps) for ps in tree_leaves(
                decode(store.frame(user), store.spec), is_leaf=is_packed)]
            want = ([a for a, _ in pairs], [b for _, b in pairs])
        for a, b in zip(tree_leaves(got_p) + tree_leaves(got_m),
                        tree_leaves(want[0]) + tree_leaves(want[1])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert store.evictions == 5


@pytest.mark.parametrize("name,backend", [("mlp", "kernel"), ("mlp", "vmap"),
                                          ("gemma3-1b", "vmap")])
def test_one_model_serves_two_stores_interleaved(name, backend):
    """The reference's pattern: one model, two stores of the same shapes,
    an engine on each, served A, B, A; every output bit-equal to the same
    store served under ``graph.disabled()`` by a model of its own."""
    model = _model(name)
    reqs = RequestStream(n_users=6, n_requests=12, seed=3).requests()

    def stores():
        return {"A": _store(model, users=6, cache=3, seed=0),
                "B": _store(model, users=6, cache=3, seed=5)}

    shared = stores()
    engines = {k: ServeEngine(st, model, backend=backend, max_batch=3)
               for k, st in shared.items()}
    got = [(k, engines[k].serve(reqs).outputs) for k in "ABA"]
    alone = stores()
    with graph.disabled():
        solo = {k: ServeEngine(st, _model(name), backend=backend,
                               max_batch=3) for k, st in alone.items()}
        want = [solo[k].serve(reqs).outputs for k in "ABA"]
    for (k, outs), ref in zip(got, want):
        assert sorted(outs) == sorted(ref)
        for rid, y in outs.items():
            assert np.array_equal(y.view(np.int32), ref[rid].view(np.int32))
    assert not np.array_equal(got[0][1][0], got[1][1][0])
    for k in "AB":
        assert shared[k].stats() == alone[k].stats()


def _bad_frame(frame: bytes, fault: str) -> bytes:
    if fault == "truncated":
        return frame[:-2]
    # one held bit of the bitmap cleared: the header's nnz is one too many
    b = bytearray(frame)
    i = next(i for i in range(HEADER_NBYTES, len(b)) if b[i])
    b[i] &= b[i] - 1
    return bytes(b)


@pytest.mark.parametrize("payload", [np.float32, np.float16])
@pytest.mark.parametrize("fault", ["truncated", "bitmap"])
def test_a_frame_that_fails_to_decode(fault, payload):
    """A frame cut short, or one whose bitmap holds fewer bits than its
    values, raises before any slot changes, and leaves the store as the
    reference's ``ModelStore`` leaves it for the same frames: equal
    ``stats()`` (a miss counted, nothing evicted) and every user resident
    as there.  The store then serves on, every slot its user's decoded
    model."""
    import jax
    import jax.numpy as jnp

    from repro.serve import ModelStore as RefStore

    model = _model("mlp")
    store = _store(model, users=3, cache=2, payload=payload)
    ref = RefStore(jax.tree.map(lambda x: jnp.asarray(x.numpy()), store.base),
                   cache_size=2, payload_dtype=payload)
    good = store.frame(2)
    for s in (store, ref):
        s._frames, s._nnz = dict(store._frames), dict(store._nnz)
        s.acquire(0), s.acquire(1)
        s._frames[2] = _bad_frame(good, fault)
    before = store.stats()
    for s in (store, ref):
        with pytest.raises(ValueError):
            s.acquire(2)
    after = store.stats()
    assert after == ref.stats()
    assert after["misses"] == before["misses"] + 1
    assert after["evictions"] == before["evictions"] == 0
    assert after["resident"] == 2
    assert [store.resident(u) for u in range(3)] == [
        ref.resident(u) for u in range(3)] == [True, True, False]
    store._frames[2] = good
    for user in (2, 0, 1):
        slot = store.acquire(user)
        got = [x[slot] for x in tree_leaves(store._pool)]
        fresh = _store(model, users=3, cache=2, payload=payload)
        want = [x[fresh.acquire(user)] for x in tree_leaves(fresh._pool)]
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))


class _Made(TorchDispatchMode):
    """The sizes and dtypes of the tensors ops return outside ``held``'s
    storages (the pool's: its slices are views, not copies)."""

    def __init__(self, held):
        super().__init__()
        self.held = {x.untyped_storage().data_ptr() for x in held}
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.untyped_storage()
                    .data_ptr() not in self.held):
                self.made.append((t.numel(), t.dtype))
        return out


@pytest.mark.parametrize("cold", [False, True])
def test_miss_holds_the_decoded_model_once(cold):
    """A miss decodes an fp32 frame (or, ``cold``, takes the base for a
    user with no frame) straight into its slot: no float32 tensor of a
    leaf's size (a decoded copy a write would then move) is made.  (An
    fp16 frame's folds make no copy on the card, where the fold kernel
    writes the slot in place; the CPU's plain fold makes temporaries of
    its own.)"""
    model = _model("mlp")
    store = _store(model)
    sizes = {x.numel() for x in tree_leaves(store.base)}
    user = 9 if cold else 2
    with _Made(tree_leaves(store._pool)) as seen:
        slot = store.acquire(user)
    assert not [n for n, dt in seen.made
                if dt == torch.float32 and n in sizes]
    assert store.resident(user) and 0 <= slot < store.cache_size


def test_warmup_changes_no_slot_and_no_counter():
    model = _model("mlp")
    store = _store(model)
    store.acquire(0), store.acquire(1)
    pool, stats = tree_map(torch.clone, store._pool), store.stats()
    engine = ServeEngine(store, model, backend="kernel")
    engine.warmup()
    assert _equal(store._pool, pool) and store.stats() == stats
