"""Serving the CNN task model (``TaskModel``) and the LM families
(``ArchModel``) in the port against the JAX reference, on the CPU.

Every model family the reference's serving CLI names (``--model smallcnn``
and the ten smoke archs) is served from one store built from the
reference's weights and masks (``init`` + ``init_mask`` under
``jax.random``, carried across as numpy arrays): two users at density 0.5,
a 2-slot pool, max batch 2, four requests, one row each; the LMs prefill a
4-token prompt.

Checks: codec frames and ``bytes_at_rest`` equal to the reference's; served
outputs within 1e-5 of the reference's at the output's scale
(``max|port - ref| <= 1e-5 * max(1, max|ref|)``: the tied-embedding
logits have a standard deviation of 16, see ``test_torch_lm.py``); every
request served in a mixed batch bit-equal to the same request served alone
through a launch of the same width (the reference's acceptance test); a
reference ``RoundEngine.save`` archive served through ``TaskModel`` equal to
the task forward; the CLI serving every family with ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE_ARCHS
from repro.core.masks import apply_mask as ref_apply_mask
from repro.core.masks import init_mask as ref_init_mask
from repro.fl import make_cnn_task as ref_make_cnn_task
from repro.serve import ModelStore as RefStore
from repro.serve import RequestStream as RefStream
from repro.serve import ServeEngine as RefEngine
from repro.serve import TaskModel as RefTaskModel
from repro.serve.model import ArchModel as RefArchModel
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.fl.base import make_cnn_task
from repro_torch.launch import serve as port_cli
from repro_torch.serve import (
    ArchModel,
    ModelStore,
    RequestStream,
    ServeEngine,
    TaskModel,
)

pytestmark = pytest.mark.tier1

TOL = 1e-5
MODELS = ["smallcnn"] + sorted(SMOKE_ARCHS)
N_USERS, CACHE, MAX_BATCH, N_REQUESTS, PROMPT = 2, 2, 2, 4, 4
# a stream of two batches, each holding both users (the reference's own
# test stream, seed 6, sends all four requests to user 1, one per batch)
SEED = 2
SUMMARY_KEYS = {
    "event", "backend", "requests", "batches", "mean_batch", "p50_ms",
    "p99_ms", "p50_wait_ms", "p99_wait_ms", "p50_service_ms",
    "p99_service_ms", "requests_per_s", "service_s", "wall_s", "warmup_s",
    "cache_hit_rate", "store_users", "store_cache_size", "store_resident",
    "store_hits", "store_misses", "store_evictions", "store_bytes_at_rest"}



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run eager forwards of tiny models, hundreds of small ops
    each; under the suite's parallel workers torch's intra-op threads only
    contend for the cores, so the module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name):
    """(reference model, port model) of one family at test width."""
    if name == "smallcnn":
        return (RefTaskModel(ref_make_cnn_task("smallcnn", 10, 8, width=4),
                             hw=8),
                TaskModel(make_cnn_task("smallcnn", 10, 8, width=4,
                                        device="cpu"), hw=8))
    return (RefArchModel(REF_SMOKE_ARCHS[name], prompt_len=PROMPT),
            ArchModel(SMOKE_ARCHS[name], prompt_len=PROMPT))


def _port_store(case):
    store = ModelStore(tree_from_numpy(case["base"]), cache_size=CACHE)
    for u, (p, m) in enumerate(case["users"]):
        store.put(u, tree_from_numpy(p), tree_from_numpy(m))
    return store


@pytest.fixture(scope="module", params=MODELS)
def served(request):
    """One family: the reference's base and users (numpy), its store, and
    its served outputs for the request stream, built once."""
    name = request.param
    ref_model, model = _models(name)
    base = ref_model.init(jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * N_USERS)
    users = []
    for u in range(N_USERS):
        p = ref_model.init(keys[2 * u])
        m = ref_init_mask(keys[2 * u + 1], p, 0.5)
        users.append((_np(ref_apply_mask(p, m)), _np(m)))
    ref_store = RefStore(base, cache_size=CACHE)
    for u, (p, m) in enumerate(users):
        ref_store.put(u, jax.tree.map(jnp.asarray, p),
                      jax.tree.map(jnp.asarray, m))
    reqs = RefStream(n_users=N_USERS, n_requests=N_REQUESTS,
                     seed=SEED).requests()
    res = RefEngine(ref_store, ref_model, backend="vmap",
                    max_batch=MAX_BATCH).serve(reqs)
    return {"name": name, "model": model, "base": _np(base), "users": users,
            "ref_store": ref_store, "ref_outputs": res.outputs,
            "ref_summary": res.summary}


def test_frames_and_bytes_at_rest_match_reference(served):
    store, ref = _port_store(served), served["ref_store"]
    for u in range(N_USERS):
        assert store.frame(u) == ref._frames[u]
        assert store.bytes_at_rest(u) == ref.bytes_at_rest(u)
        assert store.nnz(u) == ref.nnz(u)
    assert store.total_bytes_at_rest() == ref.total_bytes_at_rest()


def test_served_outputs_match_reference(served):
    model, store = served["model"], _port_store(served)
    reqs = RequestStream(n_users=N_USERS, n_requests=N_REQUESTS,
                         seed=SEED).requests()
    res = ServeEngine(store, model, backend="vmap",
                      max_batch=MAX_BATCH).serve(reqs)
    assert sorted(res.outputs) == sorted(served["ref_outputs"])
    for key in ("requests", "batches", "store_hits", "store_misses",
                "store_evictions", "store_bytes_at_rest"):
        assert res.summary[key] == served["ref_summary"][key], key
    for rid, want in served["ref_outputs"].items():
        got = res.outputs[rid]
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= TOL * scale, (served["name"], rid, err, scale)


def test_mixed_batch_bit_equal_to_alone(served):
    """The acceptance test of the reference (``tests/test_serve.py``): a
    request served in a mixed-user batch is bit-equal to the same request
    served alone through a launch of the same width (the pool's), in the
    batched run's service order, so each user holds the same pool slot
    (a vmapped convolution's rounding on the CPU depends on the slot)."""
    model = served["model"]
    reqs = RequestStream(n_users=N_USERS, n_requests=N_REQUESTS,
                         seed=SEED).requests()
    batched = ServeEngine(_port_store(served), model, backend="vmap",
                          max_batch=MAX_BATCH).serve(reqs)
    assert batched.summary["mean_batch"] == 2         # users really mixed
    alone = ServeEngine(_port_store(served), model, backend="vmap",
                        max_batch=MAX_BATCH)
    by_rid = {r.rid: r for r in reqs}
    for r in (by_rid[rid] for rid in batched.outputs):
        want = alone.serve([r], warmup=False).outputs[r.rid]
        assert np.array_equal(want, batched.outputs[r.rid]), r.rid


def test_make_input_matches_reference():
    for name in ("smallcnn", "qwen3-8b", "seamless-m4t-large-v2"):
        ref_model, model = _models(name)
        for seed in (0, 7, 2 ** 31 - 2):
            got, want = model.make_input(seed), ref_model.make_input(seed)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_vmap_only_models_refuse_other_backends():
    for name in ("smallcnn", "gemma3-1b"):
        _, model = _models(name)
        assert model.backends() == ("vmap",)
        with pytest.raises(ValueError, match="only the vmap backend"):
            model.batched_forward({}, {}, torch.zeros(1), backend="kernel")


def test_task_model_serves_a_reference_archive(tmp_path):
    """A reference ``RoundEngine.save`` archive loads into the port's store
    and serves the task forward, as ``tests/test_serve.py`` checks for the
    reference."""
    from repro.data import build_federated_image_task
    from repro.fl import FLConfig, RoundEngine, make_strategy

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="pathological", classes_per_client=2,
        n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
    cfg = FLConfig(n_clients=4, rounds=2, local_epochs=1, batch_size=16,
                   degree=2, eval_every=2)
    eng = RoundEngine(make_strategy("dispfl"),
                      ref_make_cnn_task("smallcnn", 10, 8, width=4), clients,
                      cfg, local_exec="loop")
    eng.run()
    path = str(tmp_path / "dispfl.npz")
    eng.save(path)

    store = ModelStore.from_checkpoint(path, cache_size=4, device="cpu")
    assert store.users() == [0, 1, 2, 3]
    tm = TaskModel(make_cnn_task("smallcnn", 10, 8, width=4, device="cpu"),
                   hw=8)
    reqs = RequestStream(n_users=4, n_requests=8, seed=5).requests()
    res = ServeEngine(store, tm, backend="vmap", max_batch=2).serve(reqs)
    for r in reqs:
        p, _ = store.get(r.user)
        want = tm.forward(p, torch.from_numpy(tm.make_input(r.input_seed)))
        assert np.array_equal(want.numpy(), res.outputs[r.rid]), r.rid


@pytest.mark.parametrize("name", MODELS)
def test_serve_cli_serves_every_model_on_cpu(name, tmp_path):
    jsonl = tmp_path / "serve.jsonl"
    out = port_cli.main(["--device", "cpu", "--model", name, "--users", "2",
                         "--cache-size", "2", "--max-batch", "2",
                         "--requests", "4", "--rows", "1",
                         "--metrics-jsonl", str(jsonl)])
    assert set(out) == SUMMARY_KEYS
    assert out["requests"] == 4 and out["store_users"] == 2
    assert out["store_hits"] + out["store_misses"] == 4
    assert out["backend"] == "vmap" and out["store_bytes_at_rest"] > 0
    assert '"event": "summary"' in jsonl.read_text().splitlines()[-1]
