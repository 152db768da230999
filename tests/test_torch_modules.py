"""Module-by-module parity of the PyTorch port with the JAX reference, on the
CPU, from the same numpy inputs.

Exact: tree paths, archives, data, topology, ERK budgets, accounting, FLOP
maps, bitmaps, pack/unpack, gossip, evolve (ties included).  Convolutions
and the SGD step agree to fp32 rounding: rtol 1e-5, atol 1e-5 for the
forward and the gradients, atol 1e-7 for one SGD step.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as ref_save
from repro.core import accounting as ref_acc
from repro.core import evolve as ref_evolve
from repro.core import masks as ref_masks
from repro.core import topology as ref_topo
from repro.core.gossip import gossip_average_one as ref_gossip_one
from repro.data import build_federated_image_task as ref_build
from repro.fl.engine import RoundEngine as RefEngine
from repro.fl.engine import _pack as ref_pack_lists
from repro.models import cnn as ref_cnn
from repro.optim import SGDConfig as RefSGD
from repro.optim import masked_sgd_step as ref_masked_sgd
from repro.sparse import pack as ref_pack
from repro.sparse import pack_tree as ref_pack_tree
from repro.sparse import unpack as ref_unpack
from repro.sparse.ops import packed_axpy as ref_packed_axpy
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.core import accounting, evolve, masks, topology
from repro_torch.core.gossip import gossip_average_one
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import RoundEngine, make_strategy, strategy_names
from repro_torch.models import cnn
from repro_torch.optim.sgd import SGDConfig, masked_sgd_step
from repro_torch.sparse import ops as port_ops
from repro_torch.sparse.packed import (
    pack,
    pack_tree,
    unpack,
    unpack_mask_tree,
    unpack_tree,
    words_from_numpy,
    words_to_numpy,
)
from repro_torch.utils.tree import tree_leaves_with_path, tree_map, tree_nnz
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1


def _np_tree(tree):
    return {p: np.asarray(x) for p, x in ref_leaves(tree)}


def _port_np(tree):
    return {p: x.detach().numpy() for p, x in tree_leaves_with_path(tree)}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _to_jax(tree):
    return tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def _assert_equal_trees(a: dict, b: dict, **tol):
    assert list(a) == list(b)
    for k in a:
        if tol:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# trees and archives
# ---------------------------------------------------------------------------


def test_tree_paths_and_order_match_reference():
    tree = {"b": [np.zeros(2), {"z": np.ones(1), "a": np.ones(3)}],
            "a": {"w": np.zeros((2, 2))}, "c": None}
    assert [p for p, _ in tree_leaves_with_path(tree)] == \
        [p for p, _ in ref_leaves(tree)]


def test_tree_helpers_free_their_trees_without_the_cyclic_collector():
    """A tree walked by ``tree_leaves``/``tree_map`` is freed as soon as its
    last reference goes: the helpers form no reference cycle that would
    keep it (at full width, a whole model) alive until ``gc`` runs."""
    import gc
    import weakref

    from repro_torch.utils.tree import tree_leaves, tree_unstack

    enabled = gc.isenabled()
    gc.disable()
    try:
        tree = {"a": [torch.zeros((2, 3)), {"b": torch.ones((2, 1))}],
                "c": torch.zeros((2, 2))}
        refs = [weakref.ref(x) for x in tree_leaves(tree)]
        tree_map(torch.neg, tree)
        tree_unstack(tree, 2)
        del tree
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_archive_round_trip_reference_port_reference(tmp_path):
    task = make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")
    clients, _ = build_federated_image_task(0, n_clients=3, hw=8,
                                            n_train_per_class=4)
    port = RoundEngine(make_strategy("dispfl"), task, clients,
                       FLConfig(n_clients=3, rounds=2, degree=2))
    rng = np.random.default_rng(0)
    state = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        _to_jax(port.state))
    ref = RefEngine.__new__(RefEngine)
    ref._next_round, ref.state = 1, state
    ref._acc_history, ref._acc_stds = [1 / 3], [0.1 + 1e-12]
    ref._eval_rounds = [0]
    ref._comm = {k: [rng.random()] for k in
                 ("busiest_mb", "avg_per_node_mb", "total_mb",
                  "busiest_mb_with_bitmap")}
    ref._flops = {k: [rng.random() * 1e12] for k in
                  ("per_round_flops", "dense_per_round_flops",
                   "fwd_flops_per_sample")}
    ref.save(str(tmp_path / "ref.npz"))
    port.restore(str(tmp_path / "ref.npz"))
    port.save(str(tmp_path / "port.npz"))
    back = RefEngine.__new__(RefEngine)
    back.restore(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_equal_trees(_np_tree(back.state), _np_tree(ref.state))
    assert back._acc_stds == ref._acc_stds and back._flops == ref._flops
    assert port._next_round == 1 and port.state["params"][0]["fc"]["w"].dtype \
        == torch.float32
    ref_save(str(tmp_path / "lists.npz"), ref_pack_lists({"l": [jnp.ones(2)]}))
    assert "l/__list__/000000" in np.load(tmp_path / "lists.npz").files


# ---------------------------------------------------------------------------
# numpy copies: data, topology, ERK, accounting, FLOP maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["dirichlet", "pathological"])
def test_data_identical(partition):
    kw = dict(n_clients=5, partition=partition, n_train_per_class=12, hw=8)
    a, ta = ref_build(3, **kw)
    b, tb = build_federated_image_task(3, **kw)
    np.testing.assert_array_equal(ta.x, tb.x)
    for ca, cb in zip(a, b):
        for f in ("train_x", "train_y", "test_x", "test_y", "label_dist"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))


@pytest.mark.parametrize("kind", ["random", "ring", "fc"])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_topology_identical(kind, drop):
    for t in range(4):
        np.testing.assert_array_equal(
            topology.make_adjacency(kind, 9, t, 3, 5, drop),
            ref_topo.make_adjacency(kind, 9, t, 3, 5, drop))


def test_erk_budgets_and_flops_identical():
    params = cnn.init_resnet18(torch.Generator().manual_seed(0), 10)
    shapes = {p: tuple(x.shape) for p, x in tree_leaves_with_path(params)
              if x.ndim >= 2}
    for d in (0.5, 0.2, 1.0):
        dens = masks.erk_densities_for_params(params, d)
        assert dens == ref_masks.erk_layer_densities(shapes, d)
        ref_budgets = {p: int(round(dens[p] * int(np.prod(s))))
                       for p, s in shapes.items()}
        assert evolve.layer_nnz_budgets(params, dens) == ref_budgets
    assert masks.annealed_density(0.5, 0.1, 3, 7) == \
        ref_masks.annealed_density(0.5, 0.1, 3, 7)
    assert cnn.resnet18_fwd_flops(10, 32) == ref_cnn.resnet18_fwd_flops(10, 32)
    assert cnn.vgg11_fwd_flops(10, 32) == ref_cnn.vgg11_fwd_flops(10, 32)
    assert cnn.smallcnn_fwd_flops(10, 8, 4) == ref_cnn.smallcnn_fwd_flops(10, 8, 4)
    dens = masks.erk_densities_for_params(params, 0.5)
    fl = cnn.resnet18_fwd_flops(10, 32)
    assert asdict(accounting.sparse_training_flops(fl, dens, 50, 5, 1, 32)) \
        == asdict(ref_acc.sparse_training_flops(fl, dens, 50, 5, 1, 32))


def test_comm_accounting_identical():
    a = topology.make_adjacency("random", 8, 2, 3, 1)
    nnz = [1000 + 37 * k for k in range(8)]
    assert asdict(accounting.decentralized_comm(a, nnz, 5000)) == \
        asdict(ref_acc.decentralized_comm(a, nnz, 5000))


# ---------------------------------------------------------------------------
# models and optimizer
# ---------------------------------------------------------------------------


def _batch(hw, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def test_smallcnn_forward_and_grad_match():
    from repro.fl import make_cnn_task as ref_make_task
    ref_task = ref_make_task("smallcnn", 10, 8, width=4)
    task = make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")
    tp = task.init_fn(torch.Generator().manual_seed(1))
    params = _to_jax(tp)
    x, y = _batch(8)
    np.testing.assert_allclose(
        task.apply_fn(tp, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jax.jit(ref_task.apply_fn)(params, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    loss_r, g_r = ref_task.value_and_grad(params, x, y)
    loss_p, g_p = task.value_and_grad(tp, x, y)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)
    _assert_equal_trees(_port_np(g_p), _np_tree(g_r), rtol=1e-5, atol=1e-5)
    assert task.accuracy(tp, x, y) == ref_task.accuracy(params, x, y)


def test_resnet18_forward_matches():
    tp = cnn.init_resnet18(torch.Generator().manual_seed(2), 10)
    params = _to_jax(tp)
    x, _ = _batch(8, n=2)
    got = cnn.resnet18_apply(tp, torch.from_numpy(x))
    want = jax.jit(ref_cnn.resnet18_apply)(params, jnp.asarray(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_vgg11_forward_matches():
    tp = cnn.init_vgg11(torch.Generator().manual_seed(3), 10)
    x, _ = _batch(32, n=1)
    got = cnn.vgg11_apply(tp, torch.from_numpy(x))
    want = jax.jit(ref_cnn.vgg11_apply)(_to_jax(tp), jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_same_padding_is_asymmetric_like_xla():
    assert cnn._same_pads(16, 3, 2) == (0, 1)
    assert cnn._same_pads(7, 3, 2) == (1, 1)
    assert cnn._same_pads(16, 1, 2) == (0, 0)
    assert cnn._same_pads(8, 3, 1) == (1, 1)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_masked_sgd_step_matches(momentum):
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 3, 2, 4), "b": (5,)}
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.random(s) < 0.5).astype(np.float32) for k, s in shapes.items()}
    mu = {k: rng.normal(size=s).astype(np.float32) * m[k] for k, s in shapes.items()}
    st_r = {"mu": jax.tree.map(jnp.asarray, mu)} if momentum else {}
    st_p = {"mu": _to_torch(mu)} if momentum else {}
    cfg_r, cfg_p = RefSGD(momentum=momentum), SGDConfig(momentum=momentum)
    wr, sr = ref_masked_sgd(*(jax.tree.map(jnp.asarray, t) for t in (w, g, m)),
                            st_r, cfg_r, 0.05)
    wp, sp = masked_sgd_step(_to_torch(w), _to_torch(g), _to_torch(m), st_p,
                             cfg_p, 0.05)
    _assert_equal_trees(_port_np(wp), _np_tree(wr), rtol=0, atol=1e-7)
    if momentum:
        _assert_equal_trees(_port_np(sp["mu"]), _np_tree(sr["mu"]),
                            rtol=0, atol=1e-7)
    for k in shapes:                     # dormant coordinates stay exactly 0
        assert np.all(wp[k].numpy()[m[k] == 0] == 0)


# ---------------------------------------------------------------------------
# packed payloads, gossip, evolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 7), (1, 129), (33,), (31,), (128, 3)])
@pytest.mark.parametrize("density", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("fp16", [False, True])
def test_pack_bitmaps_and_values_bitwise(shape, density, fp16):
    rng = np.random.default_rng(int(np.prod(shape)))
    w = rng.normal(size=shape).astype(np.float32)
    m = (rng.random(shape) < density).astype(np.float32)
    dt_r = np.float16 if fp16 else None
    dt_p = torch.float16 if fp16 else None
    ref = ref_pack(jnp.asarray(w * m), jnp.asarray(m), dtype=dt_r)
    got = pack(torch.from_numpy(w * m), torch.from_numpy(m), dtype=dt_p)
    np.testing.assert_array_equal(words_to_numpy(got.bitmap),
                                  np.asarray(ref.bitmap))
    assert words_to_numpy(got.bitmap).dtype == np.uint32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(unpack(got).numpy(), np.asarray(ref_unpack(ref)))
    np.testing.assert_array_equal(
        words_to_numpy(words_from_numpy(np.asarray(ref.bitmap))),
        np.asarray(ref.bitmap))
    vals, mk = port_ops.decode(got)
    np.testing.assert_array_equal(vals.numpy(), unpack(got).float().numpy())
    np.testing.assert_array_equal(mk.numpy(), m)


def _gossip_world(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"conv/w": (3, 3, 2, 4), "fc/w": (17, 10), "fc/b": (10,)}

    def tree(density):
        m = {k: (rng.random(s) < (density if k != "fc/b" else 1.1))
             .astype(np.float32) for k, s in shapes.items()}
        w = {k: rng.normal(size=s).astype(np.float32) * m[k]
             for k, s in shapes.items()}
        return w, m

    own = tree(0.5)
    nbrs = [tree(d) for d in (0.3, 0.7, 0.5)]
    return own, nbrs


def test_gossip_and_packed_gossip_bitwise():
    (w, m), nbrs = _gossip_world()
    want = ref_gossip_one(*(jax.tree.map(jnp.asarray, t) for t in (w, m)),
                          [jax.tree.map(jnp.asarray, x) for x, _ in nbrs],
                          [jax.tree.map(jnp.asarray, y) for _, y in nbrs])
    dense = gossip_average_one(_to_torch(w), _to_torch(m),
                               [_to_torch(x) for x, _ in nbrs],
                               [_to_torch(y) for _, y in nbrs])
    _assert_equal_trees(_port_np(dense), _np_tree(want))
    port_ops.reset_counters()
    packs = [pack_tree(_to_torch(x), _to_torch(y)) for x, y in nbrs]
    got = port_ops.packed_gossip_one(_to_torch(w), _to_torch(m), packs)
    _assert_equal_trees(_port_np(got), _np_tree(want))
    assert port_ops.COUNTERS["accum_calls"] == 3 * 3
    ref_packs = ref_pack_tree(*(jax.tree.map(jnp.asarray, t) for t in nbrs[0]))
    axpy_r = ref_packed_axpy(jax.tree.map(jnp.asarray, w), ref_packs, 0.25)
    axpy_p = port_ops.packed_axpy(_to_torch(w), packs[0], 0.25)
    _assert_equal_trees(_port_np(axpy_p), _np_tree(axpy_r))
    _assert_equal_trees(_port_np(unpack_tree(packs[1])), _np_tree(nbrs[1][0]))
    _assert_equal_trees(_port_np(unpack_mask_tree(packs[1])),
                        _np_tree(nbrs[1][1]))


def test_evolve_bitwise_with_ties():
    rng = np.random.default_rng(5)
    shapes = {"conv/w": (3, 3, 4, 8), "fc/w": (16, 10), "fc/b": (10,)}
    m = {k: (rng.random(s) < 0.5).astype(np.float32) for k, s in shapes.items()}
    m["fc/b"] = np.ones(10, np.float32)
    # few distinct magnitudes (ties in both the prune and the regrow ranking),
    # and exact-zero gradients
    w = {k: (rng.integers(-3, 4, size=s) * 0.5).astype(np.float32) * m[k]
         for k, s in shapes.items()}
    g = {k: (rng.integers(-2, 3, size=s) * 0.25).astype(np.float32)
         for k, s in shapes.items()}
    budgets = {k: int(m[k].sum()) for k in ("conv/w", "fc/w")}
    for rate in (0.5, 0.25, 0.0):
        mr, wr = ref_evolve.evolve_masks(
            *(jax.tree.map(jnp.asarray, t) for t in (w, m, g)), rate, budgets)
        mp, wp = evolve.evolve_masks(
            *(_to_torch(t) for t in (w, m, g)), rate, budgets)
        _assert_equal_trees(_port_np(mp), _np_tree(mr))
        _assert_equal_trees(_port_np(wp), _np_tree(wr))
        for k, b in budgets.items():
            assert int(mp[k].sum()) == b
    assert evolve.cosine_prune_rate(0.5, 3, 10) == \
        ref_evolve.cosine_prune_rate(0.5, 3, 10)


def test_schedules_identical():
    from repro.optim import schedules as ref_sched
    from repro_torch.optim import schedules
    assert schedules.exp_decay(0.1, 0.998, 7) == ref_sched.exp_decay(0.1, 0.998, 7)
    for step in (0, 3, 10, 12):
        assert schedules.cosine_schedule(0.1, step, 10) == \
            ref_sched.cosine_schedule(0.1, step, 10)


# ---------------------------------------------------------------------------
# strategy-level checks on the port alone
# ---------------------------------------------------------------------------


def _port_engine(name="dispfl", **kw):
    task = make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")
    clients, _ = build_federated_image_task(
        1, n_clients=4, partition="pathological", n_train_per_class=12,
        n_test_per_client=8, hw=8)
    cfg = FLConfig(n_clients=4, rounds=2, local_epochs=1, batch_size=8,
                   degree=2)
    return RoundEngine(make_strategy(name, **kw), task, clients, cfg,
                       local_exec="loop")


def test_registry_and_dense_mix_equals_packed_mix():
    assert strategy_names() == [
        "dfedalt", "dfedsam", "dispfl", "dispfl_anneal", "ditto", "dpsgd",
        "dpsgd_ft", "fedavg", "fedavg_ft", "fomo", "local", "subfedavg"]
    a, b = _port_engine(packed=True), _port_engine(packed=False)
    b.state = tree_map(torch.clone, a.state)
    for ra, rb in zip(a.rounds(), b.rounds()):
        da, db = ra.to_dict(), rb.to_dict()
        da.pop("wall_s"), db.pop("wall_s")
        assert da == db
    _assert_equal_trees(_port_np(a.state), _port_np(b.state))
    budgets = a.strategy.budgets_at(1, 0)
    for k in range(4):
        nnz = {p: int(x.sum()) for p, x in
               tree_leaves_with_path(a.state["masks"][k]) if p in budgets}
        assert nnz == budgets


def test_resume_matches_uninterrupted(tmp_path):
    whole = _port_engine("dispfl_anneal")
    first = _port_engine("dispfl_anneal")
    first.state = tree_map(torch.clone, whole.state)
    whole.run()
    for m in first.rounds():
        first.save(str(tmp_path / "mid.npz"))
        break
    resumed = _port_engine("dispfl_anneal").restore(str(tmp_path / "mid.npz"))
    resumed.run()
    _assert_equal_trees(_port_np(resumed.state), _port_np(whole.state))
    assert resumed._acc_history == whole._acc_history


def test_fp16_payload_keeps_masks():
    a, b = _port_engine(), _port_engine(payload_dtype="fp16")
    b.state = tree_map(torch.clone, a.state)
    a.run(), b.run()
    for k in range(4):
        _assert_equal_trees(_port_np(a.state["masks"][k]),
                            _port_np(b.state["masks"][k]))
        _assert_equal_trees(_port_np(a.state["params"][k]),
                            _port_np(b.state["params"][k]),
                            rtol=0, atol=5e-3)


def test_mix_one_folds_arrived_payloads():
    eng = _port_engine()
    strat, state = eng.strategy, eng.state
    senders = {j: strat.snapshot_message(state, j) for j in (2, 1)}
    want = gossip_average_one(state["params"][0], state["masks"][0],
                              [state["params"][j] for j in (1, 2)],
                              [state["masks"][j] for j in (1, 2)])
    strat.mix_one(state, 0, senders, None)
    _assert_equal_trees(_port_np(state["params"][0]), _port_np(want))
    assert tree_nnz(state["masks"][0]) > 0
