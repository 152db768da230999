"""The port's serving plane against the JAX reference, on the CPU, from the
same numpy inputs: codec frames, the store, the LRU, the batcher, latency
sketches, the masked-matmul plain versions and served outputs.

Inputs are made once with numpy (weights from the reference's ``init``,
masks from its ``init_mask``, then ``np.asarray``) and reach the port
through ``checkpoint.npz.tree_from_numpy``.

Tolerance: frames, sizes, LRU slots and counters, batches, waits and
quantiles must be equal.  Matmul outputs agree to fp32 rounding of a
different summation order (XLA's and the Pallas interpreter's against
PyTorch's CPU matmul): atol 1e-5, rtol 1e-5, as the reference's own
backends are held to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import apply_mask as ref_apply_mask
from repro.core.masks import init_mask as ref_init_mask
from repro.checkpoint import save_pytree as ref_save_pytree
from repro.fl.engine import _pack as ref_pack_lists
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.obs import LogHistogram as RefLogHistogram
from repro.serve import MicroBatcher as RefMicroBatcher
from repro.serve import MLPModel as RefMLP
from repro.serve import ModelStore as RefStore
from repro.serve import RequestStream as RefStream
from repro.serve import ServeEngine as RefEngine
from repro.sparse import decode_dense as ref_decode_dense
from repro.sparse import TreeSpec as RefSpec
from repro.sparse import encode as ref_encode
from repro.sparse import encoded_nbytes as ref_nbytes
from repro.sparse import pack_tree as ref_pack_tree
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.kernels import masked_matmul as mmk
from repro_torch.launch import serve as port_cli
from repro_torch.obs import LogHistogram
from repro_torch.serve import MicroBatcher, MLPModel, ModelStore, RequestStream
from repro_torch.serve import ServeEngine
from repro_torch.sparse.codec import (
    TreeSpec,
    decode,
    decode_dense,
    encode,
    encoded_nbytes,
)
from repro_torch.sparse.packed import pack_tree, unpack_mask_tree, unpack_tree
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

pytestmark = pytest.mark.tier1

TOL = dict(atol=1e-5, rtol=1e-5)
DIMS = dict(d_in=16, widths=(32,), n_out=8)
SUMMARY_KEYS = {
    "event", "backend", "requests", "batches", "mean_batch", "p50_ms",
    "p99_ms", "p50_wait_ms", "p99_wait_ms", "p50_service_ms",
    "p99_service_ms", "requests_per_s", "service_s", "wall_s", "warmup_s",
    "cache_hit_rate", "store_users", "store_cache_size", "store_resident",
    "store_hits", "store_misses", "store_evictions", "store_bytes_at_rest"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _users(n_users=6, density=0.5, rows=2, seed=0):
    """Reference base + per-user (w ⊙ m, m) as numpy trees."""
    model = RefMLP(rows=rows, **DIMS)
    base = _np(model.init(jax.random.PRNGKey(seed)))
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), 2 * n_users)
    users = []
    for u in range(n_users):
        p = model.init(keys[2 * u])
        m = ref_init_mask(keys[2 * u + 1], p, density)
        users.append((_np(ref_apply_mask(p, m)), _np(m)))
    return base, users


def _stores(cache_size=3, **kw):
    base, users = _users(**kw)
    ref = RefStore(jax.tree.map(jnp.asarray, base), cache_size=cache_size)
    port = ModelStore(tree_from_numpy(base), cache_size=cache_size)
    for u, (p, m) in enumerate(users):
        a = ref.put(u, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, m))
        b = port.put(u, tree_from_numpy(p), tree_from_numpy(m))
        assert a == b
    return ref, port


def _assert_same_tree(ref_tree, port_tree):
    ra, pa = ref_leaves(ref_tree), tree_leaves_with_path(port_tree)
    assert [p for p, _ in ra] == [p for p, _ in pa]
    for (path, x), (_, y) in zip(ra, pa):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=path)


# ---------------------------------------------------------------------------
# codec and store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("wire", [np.float32, np.float16])
def test_codec_frames_byte_identical(density, wire):
    _, users = _users(n_users=2, density=density)
    tdtype = {np.float32: torch.float32, np.float16: torch.float16}[wire]
    for p, m in users:
        ref_packed = ref_pack_tree(jax.tree.map(jnp.asarray, p),
                                   jax.tree.map(jnp.asarray, m), dtype=wire)
        packed = pack_tree(tree_from_numpy(p), tree_from_numpy(m), dtype=tdtype)
        frame = encode(packed)
        assert frame == ref_encode(ref_packed)
        assert len(frame) == encoded_nbytes(packed) == ref_nbytes(ref_packed)
        spec = TreeSpec.from_tree(tree_from_numpy(p), dtype=wire)
        rp, rm = ref_decode_dense(frame, RefSpec.from_tree(p, dtype=wire))
        dp, dm = decode_dense(frame, spec)
        _assert_same_tree(rp, dp)
        _assert_same_tree(rm, dm)
        # decode -> unpack equals decode_dense, and re-encodes to the frame
        back = decode(frame, spec)
        _assert_same_tree(rp, unpack_tree(back))
        _assert_same_tree(rm, unpack_mask_tree(back))
        assert encode(back) == frame


def test_store_sizes_frames_and_roundtrip_match_reference():
    ref, port = _stores(n_users=5, density=0.3)
    assert port.users() == ref.users()
    for u in ref.users():
        assert port.bytes_at_rest(u) == ref.bytes_at_rest(u)
        assert port.frame(u) == ref._frames[u]
        assert port.nnz(u) == ref.nnz(u)
        rp, rm = ref.get(u)
        pp, pm = port.get(u)
        _assert_same_tree(rp, pp)
        _assert_same_tree(rm, pm)
    assert port.total_bytes_at_rest() == ref.total_bytes_at_rest()
    assert port.stats() == ref.stats()
    # cold start: the base with an all-ones mask
    rp, rm = ref.get(99)
    pp, pm = port.get(99)
    _assert_same_tree(rp, pp)
    _assert_same_tree(rm, pm)


def test_lru_slots_and_counters_match_reference():
    ref, port = _stores(n_users=7, cache_size=3)
    reqs = RefStream(n_users=9, n_requests=60, seed=3).requests()
    ref_slots, port_slots = [], []
    for b in RefMicroBatcher(reqs, max_batch=3, max_wait=0.002,
                             resident=ref.resident).batches():
        ref_slots.append([ref.acquire(r.user) for r in b.requests])
    port_reqs = RequestStream(n_users=9, n_requests=60, seed=3).requests()
    for b in MicroBatcher(port_reqs, max_batch=3, max_wait=0.002,
                          resident=port.resident).batches():
        port_slots.append([port.acquire(r.user) for r in b.requests])
    assert port_slots == ref_slots
    assert (port.hits, port.misses, port.evictions) == \
        (ref.hits, ref.misses, ref.evictions)
    assert port.evictions > 0 and port.hits > 0
    assert port.stats() == ref.stats()


def _reference_archive(tmp_path):
    """An archive in the layout the reference's ``RoundEngine.save`` writes
    (``engine`` + ``__list__``-packed ``state``): three clients' masked
    MLP weights with ERK masks, plus an unmasked bias per layer."""
    _, users = _users(n_users=3, density=0.4)
    rng = np.random.default_rng(8)
    params, masks = [], []
    for p, m in users:
        for name in p:
            d = p[name]["w"].shape[1]
            p[name]["b"] = rng.standard_normal(d).astype(np.float32)
            m[name]["b"] = np.ones(d, np.float32)
        params.append(p)
        masks.append(m)
    path = str(tmp_path / "engine.npz")
    ref_save_pytree(path, {
        "engine": {"next_round": np.asarray(1, np.int64)},
        "state": ref_pack_lists({"params": params, "masks": masks})})
    return path


def test_store_from_reference_checkpoint_matches_reference(tmp_path):
    path = _reference_archive(tmp_path)
    ref = RefStore.from_checkpoint(path, cache_size=2)
    port = ModelStore.from_checkpoint(path, cache_size=2, device="cpu")
    assert port.users() == ref.users() == [0, 1, 2]
    for u in ref.users():
        assert port.frame(u) == ref._frames[u]
    assert port.stats() == ref.stats()
    _assert_same_tree(ref.base, port.base)
    for u in (2, 0, 1, 7):
        rp, rm = ref.get(u)
        pp, pm = port.get(u)
        _assert_same_tree(rp, pp)
        _assert_same_tree(rm, pm)
    assert port.device.type == "cpu"
    assert {x.device.type for x in tree_leaves(port.pool_params)} == {"cpu"}


def test_store_from_checkpoint_refuses_missing_gpu(tmp_path, monkeypatch):
    """The archive loader runs on CUDA unless the CPU is asked for."""
    path = _reference_archive(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelStore.from_checkpoint(path, cache_size=2)


# ---------------------------------------------------------------------------
# batcher and sketches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("popularity", ["zipf", "uniform"])
@pytest.mark.parametrize("max_batch,max_wait", [(1, 0.0), (4, 0.003),
                                                 (8, 0.05)])
def test_batcher_batches_and_waits_match_reference(popularity, max_batch,
                                                   max_wait):
    kw = dict(n_users=7, n_requests=50, seed=5, rate=800.0,
              popularity=popularity)
    ref_reqs = RefStream(**kw).requests()
    reqs = RequestStream(**kw).requests()
    assert [tuple(vars(r).values()) for r in reqs] == \
        [tuple(vars(r).values()) for r in ref_reqs]
    resident = lambda u: u % 3 == 0  # noqa: E731
    ref_b = list(RefMicroBatcher(ref_reqs, max_batch=max_batch,
                                 max_wait=max_wait, resident=resident).batches())
    got = list(MicroBatcher(reqs, max_batch=max_batch, max_wait=max_wait,
                            resident=resident).batches())
    assert [(b.t_flush, b.users, [r.rid for r in b.requests])
            for b in got] == \
        [(b.t_flush, b.users, [r.rid for r in b.requests]) for b in ref_b]
    assert [b.queue_waits() for b in got] == [b.queue_waits() for b in ref_b]


def test_log_histogram_quantiles_match_reference():
    rng = np.random.default_rng(11)
    samples = np.concatenate([rng.lognormal(0.0, 1.5, 3000), np.zeros(40)])
    ref, port = RefLogHistogram(), LogHistogram()
    small_ref, small = RefLogHistogram(max_buckets=16), LogHistogram(max_buckets=16)
    for x in samples:
        ref.add(float(x))
        port.add(float(x))
        small_ref.add(float(x))
        small.add(float(x))
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert [port.quantile(q) for q in qs] == [ref.quantile(q) for q in qs]
    assert [small.quantile(q) for q in qs] == [small_ref.quantile(q) for q in qs]
    assert port.to_dict() == ref.to_dict()
    assert small.collapsed == small_ref.collapsed > 0
    port.merge(small)
    ref.merge(small_ref)
    assert port.to_dict() == ref.to_dict()


# ---------------------------------------------------------------------------
# masked matmul: plain versions against the reference's oracle and kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_batched_plain_matches_reference_oracle_and_pallas(density):
    rng = np.random.default_rng(int(density * 100))
    u, m, k, n = 4, 5, 70, 33                    # odd shapes: padding in the reference
    x = rng.standard_normal((u, m, k)).astype(np.float32)
    w = rng.standard_normal((u, k, n)).astype(np.float32)
    mask = (rng.random((u, k, n)) < density).astype(np.float32)
    want = np.asarray(ref_oracle.batched_masked_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)))
    pallas = np.asarray(ref_ops.batched_masked_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), bm=8, bn=16, bk=32))
    tx, tw, tm = (torch.from_numpy(a) for a in (x, w, mask))
    launches = mmk.LAUNCHES
    for got in (mmk.batched_masked_matmul_plain(tx, tw, tm),
                mmk.batched_masked_matmul(tx, tw, tm)):
        assert got.shape == (u, m, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    assert mmk.LAUNCHES == launches          # CPU tensors never launch


@pytest.mark.parametrize("shape", [(64, 128, 128), (128, 256, 128),
                                   (70, 200, 90), (13, 50, 17)])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_plain_matches_reference_oracle_and_pallas(shape, density):
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + int(density * 10))
    x = rng.standard_normal((m, k)).astype(np.float32)
    # weights scaled as the served MLP's (lecun normal), so outputs are O(1)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    mask = (rng.random((k, n)) < density).astype(np.float32)
    want = np.asarray(ref_oracle.masked_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)))
    pallas = np.asarray(ref_ops.masked_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)))
    tx, tw, tm = (torch.from_numpy(a) for a in (x, w, mask))
    for got in (mmk.masked_matmul_plain(tx, tw, tm),
                mmk.masked_matmul(tx, tw, tm)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("k,n,bk,bn", [(256, 384, 128, 128), (70, 33, 32, 16),
                                       (200, 90, 128, 128)])
def test_block_occupancy_matches_reference(k, n, bk, bn):
    rng = np.random.default_rng(k + n)
    mask = (rng.random((k, n)) < 0.02).astype(np.float32)
    mask[: k // 2, : n // 3] = 0.0           # whole empty tiles
    want = ref_ops.block_occupancy(jnp.asarray(mask), bk=bk, bn=bn)
    got = mmk.block_occupancy(torch.from_numpy(mask), bk=bk, bn=bn)
    assert got == pytest.approx(want, rel=0, abs=1e-7)
    batched = mmk.block_occupancy(torch.from_numpy(np.stack([mask, mask])),
                                  bk=bk, bn=bn)
    assert batched == pytest.approx(want, rel=0, abs=1e-7)


def test_wrapper_refuses_bad_dtype_and_shapes():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(TypeError, match="float32"):
        mmk.batched_masked_matmul(x.double(), w.double(), w.double())
    with pytest.raises(TypeError, match="float32"):
        mmk.batched_masked_matmul(x, w, w.bool())
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x, torch.zeros(2, 3, 5), torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x, w, torch.zeros(2, 4, 6))
    with pytest.raises(ValueError, match="contiguous"):
        mmk.batched_masked_matmul(x, w.transpose(1, 2).contiguous()
                                  .transpose(1, 2), w)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        mmk.masked_matmul(x, w, w)


# ---------------------------------------------------------------------------
# engine and CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_backend,ref_backend", [
    ("vmap", "vmap"), ("ref", "ref"), ("kernel", "pallas")])
def test_engine_outputs_and_counters_match_reference(port_backend,
                                                     ref_backend):
    ref_store, port_store = _stores(n_users=6, cache_size=3)
    reqs = RefStream(n_users=6, n_requests=20, seed=4).requests()
    ref_model = RefMLP(rows=2, **DIMS)
    model = MLPModel(rows=2, **DIMS)
    ref_res = RefEngine(ref_store, ref_model, backend=ref_backend,
                        max_batch=4).serve(reqs)
    launches = mmk.LAUNCHES
    res = ServeEngine(port_store, model, backend=port_backend,
                      max_batch=4).serve(
        RequestStream(n_users=6, n_requests=20, seed=4))
    assert mmk.LAUNCHES == launches          # the CPU runs the plain version
    assert sorted(res.outputs) == sorted(ref_res.outputs) == list(range(20))
    for rid, want in ref_res.outputs.items():
        assert res.outputs[rid].shape == want.shape == (2, 8)
        np.testing.assert_allclose(res.outputs[rid], want, **TOL)
    assert set(res.summary) == set(ref_res.summary) == SUMMARY_KEYS
    for key in ("requests", "batches", "mean_batch", "cache_hit_rate",
                "store_users", "store_resident", "store_hits",
                "store_misses", "store_evictions", "store_bytes_at_rest"):
        assert res.summary[key] == ref_res.summary[key], key
    assert res.summary["p50_wait_ms"] == ref_res.summary["p50_wait_ms"]
    assert res.summary["p99_wait_ms"] == ref_res.summary["p99_wait_ms"]


def test_engine_vmap_bit_exact_vs_per_user_loop():
    _, port_store = _stores(n_users=6, cache_size=3)
    model = MLPModel(rows=2, **DIMS)
    reqs = RequestStream(n_users=6, n_requests=24, seed=2).requests()
    res = ServeEngine(port_store, model, backend="vmap", max_batch=4).serve(reqs)
    assert sorted(res.outputs) == [r.rid for r in reqs]
    for r in reqs:
        p, _ = port_store.get(r.user)
        want = model.forward(p, torch.from_numpy(model.make_input(r.input_seed)))
        assert np.array_equal(want.numpy(), res.outputs[r.rid]), r.rid


def test_make_input_matches_reference():
    for seed in (0, 7, 2 ** 31 - 2):
        np.testing.assert_array_equal(
            MLPModel(rows=3, **DIMS).make_input(seed),
            RefMLP(rows=3, **DIMS).make_input(seed))


def test_serve_cli_on_cpu(tmp_path, capsys):
    jsonl = tmp_path / "serve.jsonl"
    argv = ["--device", "cpu", "--users", "8", "--cache-size", "4",
            "--max-batch", "4", "--requests", "32", "--rows", "4",
            "--metrics-jsonl", str(jsonl)]
    out = port_cli.main(argv + ["--backend", "kernel"])
    assert set(out) == SUMMARY_KEYS
    assert out["requests"] == 32 and out["store_users"] == 8
    assert out["store_hits"] + out["store_misses"] == 32
    lines = jsonl.read_text().splitlines()
    assert '"event": "store"' in lines[0] and '"event": "summary"' in lines[-1]
    # the same seed gives the same users and cache behaviour on any backend
    again = port_cli.main(argv + ["--backend", "vmap"])
    for key in ("store_bytes_at_rest", "store_hits", "store_misses",
                "store_evictions", "batches"):
        assert again[key] == out[key], key


def test_serve_cli_refuses_missing_gpu_and_unported_models(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--users", "2", "--requests", "2"])
    for name in ("smallcnn", "qwen3-8b"):
        with pytest.raises(SystemExit, match="not ported yet"):
            port_cli.main(["--device", "cpu", "--model", name])
