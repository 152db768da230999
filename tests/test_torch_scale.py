"""The port's stacked primitives (``repro_torch.scale.stacked``) against the
reference's ``repro.scale``, on the CPU, from the same numpy inputs; the
``ScaleEngine``'s ragged schedules and momentum against the port's loop
engine, its refusals and the ``--scale`` CLI.  The engine's runs from one
reference archive are ``test_torch_scale_engine.py``'s.

Setup as the reference's own suite: K=8, smallcnn width 4, hw 8, 3 rounds,
degree 2.  Tolerances:
- exact: masks, bitmaps, payload values and nnz, comm rows, FLOPs, the
  ordered gossip, the exact and threshold evolves, the prune/regrow apply,
  the stacked fold, the stacked eval against the loop eval;
- parameters of whole runs within atol 1e-5 (the reference's own einsum
  criterion; the measured gap after 3 rounds is ~6e-8, from the vmapped
  convolutions' fp32 rounding); accuracy histories within 1e-5;
- the einsum gossip and the plain mix within atol 1e-6 of the reference's
  (matmul summation order).
Where the reference reaches a Pallas kernel (``fold_stacked(backend=
"pallas_rows")``, ``kernels.ops.prune_regrow``) it runs in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.scale import stacked as ref_stacked
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import (
    FLConfig,
    evaluate_clients_stacked,
    make_cnn_task,
)
from repro_torch.fl.engine import RoundEngine, StrategyBase, make_strategy
from repro_torch.kernels import packed_accum as pa
from repro_torch.kernels import prune_regrow as pr
from repro_torch.launch import train as port_train
from repro_torch.scale import (
    ScaleEngine,
    fold_stacked,
    make_stacked,
    masked_gossip_stacked,
    pack_stacked,
    plain_mix_stacked,
    split_stacked,
    stack_payloads,
    stacked_evolve_exact,
    stacked_nnz_per_client,
    stacked_prune_regrow_threshold,
    stacked_strategy_names,
    unpack_stacked,
)
from repro_torch.scale.stacked import evolve_counts_for
from repro_torch.sparse.packed import words_to_numpy
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-5
ACC_ATOL = 1e-5
MIX_ATOL = 1e-6
DATA = dict(n_clients=8, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=8, rounds=3, local_epochs=2, batch_size=16, degree=2,
           eval_every=1)


def _ref_np(tree):
    return {p: np.asarray(x) for p, x in ref_leaves(tree)}


def _port_np(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_leaves_with_path(tree)}


def _assert_trees(ref_tree, port_tree, what="", atol=None):
    a, b = _ref_np(ref_tree), _port_np(port_tree)
    assert list(a) == list(b), what
    for k in a:
        if atol is None:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=f"{what} {k}")


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _port_task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _port_clients():
    return build_federated_image_task(0, **DATA)[0]


# ---------------------------------------------------------------------------
# stacked primitives from numpy inputs
# ---------------------------------------------------------------------------


def _world(k=6, density=0.5, seed=0):
    """A stacked (w, m) pair of numpy trees; biases dense, w masked."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"w": (3, 3, 2, 4)}, "fc": {"w": (17, 10), "b": (10,)}}
    m = jax.tree.map(lambda s: (rng.random((k,) + s) < density)
                     .astype(np.float32), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    m["fc"]["b"] = np.ones_like(m["fc"]["b"])
    w = jax.tree.map(lambda mm: rng.normal(size=mm.shape).astype(np.float32)
                     * mm, m)
    return w, m


@pytest.mark.parametrize("reduction", ["ordered", "einsum"])
def test_masked_gossip_stacked_matches_reference(reduction):
    from repro.core.topology import make_adjacency
    w, m = _world()
    adj = make_adjacency("random", 6, 0, 3, 0)
    want = jax.jit(lambda p, q: ref_stacked.masked_gossip_stacked(
        p, q, jnp.asarray(adj, jnp.float32), reduction))(_to_jax(w),
                                                         _to_jax(m))
    got = masked_gossip_stacked(_to_torch(w), _to_torch(m), adj, reduction)
    _assert_trees(want, got, reduction,
                  atol=None if reduction == "ordered" else MIX_ATOL)


@pytest.mark.parametrize("reduction", ["ordered", "einsum"])
def test_plain_mix_stacked_matches_reference(reduction):
    from repro.core.topology import make_adjacency
    from repro.fl.decentralized import metropolis_weights
    w, _ = _world(seed=3)
    wm = metropolis_weights(make_adjacency("random", 6, 1, 2, 0))
    want = jax.jit(lambda p: ref_stacked.plain_mix_stacked(
        p, jnp.asarray(wm, jnp.float32), reduction))(_to_jax(w))
    got = plain_mix_stacked(_to_torch(w), wm.astype(np.float32), reduction)
    _assert_trees(want, got, reduction, atol=MIX_ATOL)


def _evolve_inputs(seed=5, k=6):
    """Masked weights with few distinct magnitudes (ties in both rankings)
    and gradients with exact zeros."""
    w, m = _world(seed=seed, k=k)
    rng = np.random.default_rng(seed + 1)
    w = jax.tree.map(lambda a, mm: (np.round(a * 2) / 2).astype(np.float32)
                     * mm, w, m)
    g = jax.tree.map(lambda a: (rng.integers(-2, 3, size=a.shape) * 0.25)
                     .astype(np.float32), w)
    return w, m, g


def test_stacked_evolve_exact_and_counts_match_reference():
    from repro.core.evolve import layer_nnz_budgets
    from repro.core.masks import erk_densities_for_params
    w, m, g = _evolve_inputs()
    one = jax.tree.map(lambda a: jnp.asarray(a[0]), w)
    budgets = layer_nnz_budgets(one, erk_densities_for_params(one, 0.5))
    for rate in (0.0, 0.3, 0.77, 1.0):
        ref_counts = ref_stacked.evolve_counts_for(budgets, rate)
        counts = evolve_counts_for(budgets, rate)
        assert counts == {p: (int(a), int(b))
                          for p, (a, b) in ref_counts.items()}
        want_m, want_w = jax.jit(ref_stacked.stacked_evolve_exact)(
            _to_jax(w), _to_jax(m), _to_jax(g), ref_counts)
        got_m, got_w = stacked_evolve_exact(_to_torch(w), _to_torch(m),
                                            _to_torch(g), counts)
        _assert_trees(want_m, got_m, f"rate {rate} masks")
        _assert_trees(want_w, got_w, f"rate {rate} params")


def test_stacked_prune_regrow_threshold_matches_reference():
    """Two sparsifiable leaves (one 4-D, one whose rows have all-zero
    gradients on a client) and two dense ones; ties in |w| and |g|."""
    rng = np.random.default_rng(9)
    k = 3
    shapes = {"a": (k, 2, 64, 64), "b": (k, 64, 96), "fc": (k, 17, 10),
              "norm": (k, 64)}
    m = {p: (rng.random(s) < 0.4).astype(np.float32) for p, s in
         shapes.items()}
    w = {p: (rng.integers(-4, 5, size=s) * 0.25).astype(np.float32) * m[p]
         for p, s in shapes.items()}
    g = {p: (rng.integers(-3, 4, size=s) * 0.5).astype(np.float32)
         for p, s in shapes.items()}
    g["b"][1] = 0.0
    for rate in (0.1, 0.5):
        want_m, want_w = ref_stacked.stacked_prune_regrow_threshold(
            _to_jax(w), _to_jax(m), _to_jax(g), jnp.float32(rate), 0.4)
        got_m, got_w = stacked_prune_regrow_threshold(
            _to_torch(w), _to_torch(m), _to_torch(g), rate, 0.4)
        _assert_trees(want_m, got_m, f"rate {rate} masks")
        _assert_trees(want_w, got_w, f"rate {rate} params")
        assert np.array_equal(got_m["fc"].numpy(), m["fc"])


@pytest.mark.parametrize("n", [256, 1000, 4096])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_prune_regrow_matches_reference_ops(n, rate):
    """The sweep of the reference's kernel test, against
    ``repro.kernels.ops.prune_regrow`` (Pallas, interpret mode), with exact
    zero gradients on a tenth of the coordinates: bit for bit."""
    rng = np.random.default_rng(n)
    m = (rng.random(n) < 0.5).astype(np.float32)
    w = (rng.normal(size=n) * m).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    g[: n // 10] = 0.0
    want_m, want_w = ref_ops.prune_regrow(jnp.asarray(w), jnp.asarray(g),
                                          jnp.asarray(m), rate)
    got_m, got_w = pr.prune_regrow(torch.from_numpy(w), torch.from_numpy(g),
                                   torch.from_numpy(m), rate)
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    np.testing.assert_array_equal(np.asarray(want_w).view(np.int32),
                                  got_w.numpy().view(np.int32))
    assert abs(float(got_m.sum()) - float(m.sum())) <= max(4, 0.02 * n)


def test_prune_regrow_rows_per_row_thresholds_match_oracle():
    from repro.kernels.ref import prune_regrow_ref
    rng = np.random.default_rng(4)
    k, n = 4, 777
    m = (rng.random((k, n)) < 0.5).astype(np.float32)
    w = (rng.normal(size=(k, n)) * m).astype(np.float32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    g[2] = 0.0                                   # all-zero gradient row
    th = np.array([[0.5, 1.0], [0.0, 0.0], [np.inf, -np.inf],
                   [1.5, 0.25]], np.float32)
    got_m, got_w = pr.prune_regrow_rows(*(torch.from_numpy(a)
                                          for a in (w, g, m, th)))
    for r in range(k):
        em, ew = prune_regrow_ref(*(jnp.asarray(a[r]) for a in (w, g, m)),
                                  th[r, 0], th[r, 1])
        np.testing.assert_array_equal(np.asarray(em), got_m[r].numpy())
        np.testing.assert_array_equal(np.asarray(ew), got_w[r].numpy())
    assert float(got_m[2][m[2] == 0].sum()) == 0.0      # |g| > 0 guard
    with pytest.raises(ValueError, match="thresholds"):
        pr.prune_regrow_rows(*(torch.from_numpy(a) for a in (w, g, m)),
                             torch.from_numpy(th[:2]))


def test_pack_unpack_stacked_byte_identical():
    w, m = _world(seed=11)
    want = ref_stacked.pack_stacked(_to_jax(w), _to_jax(m))
    got = pack_stacked(_to_torch(w), _to_torch(m))
    is_sp = ref_stacked._is_stacked_packed
    for path in ("conv/w", "fc/w", "fc/b"):
        a = want
        b = got
        for key in path.split("/"):
            a, b = a[key], b[key]
        assert is_sp(a) and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a.bitmap),
                                      words_to_numpy(b.bitmap))
        assert np.asarray(a.values).dtype == b.values.numpy().dtype
        assert np.asarray(a.values).tobytes() == b.values.numpy().tobytes()
        np.testing.assert_array_equal(np.asarray(a.nnz), b.nnz.numpy())
    _assert_trees(ref_stacked.unpack_stacked(want), unpack_stacked(got))
    dense = pack_stacked(_to_torch(w), None)
    _assert_trees(_to_jax(w), unpack_stacked(dense))


def _payload_leaves(tree):
    """Packed leaves of a payload tree in path order (both packages sort
    dict keys)."""
    return jax.tree.leaves(tree, is_leaf=lambda t: hasattr(t, "bitmap"))


def _assert_payloads(ref_tree, port_tree):
    la, lb = _payload_leaves(ref_tree), _payload_leaves(port_tree)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(np.asarray(x.bitmap),
                                      words_to_numpy(y.bitmap))
        assert np.asarray(x.values).tobytes() == y.values.numpy().tobytes()


def test_split_and_stack_payloads_byte_identical():
    w, m = _world(seed=13)
    want = ref_stacked.split_stacked(ref_stacked.pack_stacked(
        _to_jax(w), _to_jax(m)))
    got = split_stacked(pack_stacked(_to_torch(w), _to_torch(m)))
    assert len(got) == len(want) == 6
    for a, b in zip(want, got):
        _assert_payloads(a, b)
    again = split_stacked(stack_payloads(got))
    for a, b in zip(got, again):
        for x, y in zip(_payload_leaves(a), _payload_leaves(b)):
            assert torch.equal(x.bitmap, y.bitmap)
            assert torch.equal(x.values, y.values)


@pytest.mark.parametrize("backend,alpha", [("ref", 1.0), ("pallas_rows", 1.0),
                                           ("pallas_rows", 0.75)])
def test_fold_stacked_matches_reference_backends(backend, alpha):
    """Into non-zero accumulators, against the reference's loop fold and
    its one-launch Pallas row fold (interpret mode): exact at alpha 1; at
    another alpha XLA contracts ``num + alpha * v`` into one FMA where the
    port rounds twice (as the flat fold's test in test_torch_kernels.py
    states), so within 1e-6 there."""
    w, m = _world(seed=17)
    rng = np.random.default_rng(3)
    num = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                       w)
    den = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), w)
    want_n, want_d = ref_stacked.fold_stacked(
        _to_jax(num), _to_jax(den),
        ref_stacked.pack_stacked(_to_jax(w), _to_jax(m)), alpha,
        backend=backend)
    pa.LAUNCHES_ROWS = 0
    got_n, got_d = fold_stacked(_to_torch(num), _to_torch(den),
                                pack_stacked(_to_torch(w), _to_torch(m)),
                                alpha)
    assert pa.LAUNCHES_ROWS == 0                     # plain version on the CPU
    _assert_trees(want_n, got_n, "num", atol=None if alpha == 1.0 else 1e-6)
    _assert_trees(want_d, got_d, "den")


def test_fold_rows_refuses_wrong_nnz():
    w, m = _world(seed=19)
    sp = pack_stacked(_to_torch(w), _to_torch(m))["fc"]["w"]
    num = torch.zeros((6, 170))
    for bad in (sp.nnz + 1, sp.nnz - 1):
        with pytest.raises(ValueError, match="set bits"):
            pa.packed_accum_rows(num.clone(), num.clone(), sp.bitmap,
                                 sp.values, bad.to(torch.int32))
    assert stacked_nnz_per_client(_to_torch(m)) == [
        int(sum(np.count_nonzero(x[k]) for x in jax.tree.leaves(m)))
        for k in range(6)]


# ---------------------------------------------------------------------------
# engines from one archive
# ---------------------------------------------------------------------------


RUNS = {"dispfl-ordered": ("dispfl", "ordered"),
        "dispfl-einsum": ("dispfl", "einsum"),
        "dispfl_anneal-ordered": ("dispfl_anneal", "ordered")}


def test_ragged_schedules_and_momentum_match_port_loop_engine():
    """Clients with 29 to 82 samples (padded no-op steps) and momentum 0.9
    (stacked optimizer state), dispfl_anneal, ``ordered``: the stacked run
    gives the loop engine's masks and accuracies, parameters within 1e-5."""
    clients = build_federated_image_task(
        2, n_clients=4, partition="dirichlet", alpha=0.5,
        n_train_per_class=20, n_test_per_client=8, hw=8)[0]
    assert len({c.n_train for c in clients}) == 4
    cfg = FLConfig(n_clients=4, rounds=2, local_epochs=2, batch_size=8,
                   degree=2, momentum=0.9)
    scale = ScaleEngine(make_strategy("dispfl_anneal"), _port_task(), clients,
                        cfg, reduction="ordered")
    loop = RoundEngine(make_strategy("dispfl_anneal"), _port_task(), clients,
                       cfg, local_exec="loop")
    loop.state = scale.adapter.unstack_state(
        {k: tree_map(torch.clone, v) for k, v in scale.state.items()})
    scale.run(), loop.run()
    assert scale._acc_history == loop._acc_history
    got = scale.adapter.unstack_state(scale.state)
    for k in range(4):
        for key, atol in (("masks", 0.0), ("params", PARAM_ATOL)):
            for (p, a), (_, b) in zip(tree_leaves_with_path(got[key][k]),
                                      tree_leaves_with_path(loop.state[key][k])):
                torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=p)


class _Named(StrategyBase):
    def __init__(self, name):
        self.name = name


def test_scale_engine_refusals():
    task, clients = _port_task(), _port_clients()
    cfg = FLConfig(**CFG)
    with pytest.raises(KeyError, match="no stacked adapter"):
        make_stacked(_Named("fedavg"))
    assert stacked_strategy_names() == ["dispfl", "dispfl_anneal", "dpsgd",
                                        "dpsgd_ft"]
    with pytest.raises(ValueError, match="reduction"):
        make_stacked(make_strategy("dispfl"), reduction="tree")
    with pytest.raises(ValueError, match="homogeneous"):
        ScaleEngine(make_strategy("dispfl"), task, clients,
                    dataclasses.replace(cfg, capacities=[0.2] * 4 + [0.8] * 4))
    with pytest.raises(ValueError, match="payload_dtype"):
        ScaleEngine(make_strategy("dispfl", payload_dtype="fp16"), task,
                    clients, cfg)
    ragged = [dataclasses.replace(clients[0], train_x=clients[0].train_x[:8],
                                  train_y=clients[0].train_y[:8])]
    with pytest.raises(ValueError, match="effective batch size"):
        ScaleEngine(make_strategy("dispfl"), task, ragged + clients[1:], cfg)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ScaleEngine(make_strategy("dispfl"), task, clients, cfg, mesh=object())


ARGV = ["simulate", "--rounds", "2", "--clients", "4", "--local-epochs", "1",
        "--samples-per-class", "8", "--hw", "8", "--width", "4",
        "--degree", "2", "--partition", "pathological"]


@pytest.mark.parametrize("reduction", ["einsum", "ordered"])
def test_cli_scale_on_cpu(reduction, tmp_path):
    ck = str(tmp_path / "ck.npz")
    out = port_train.main(ARGV + ["--scale", "--scale-reduction", reduction,
                                  "--device", "cpu", "--checkpoint", ck])
    assert {"strategy", "partition", "final_acc", "acc_history", "comm",
            "flops", "wall_s"} <= set(out)
    assert out["device"] == "cpu" and len(out["phase_s"]) == 2
    assert np.isfinite(out["final_acc"])
    loop = port_train.main(ARGV + ["--device", "cpu"])
    assert out["comm"] == loop["comm"] and out["flops"] == loop["flops"]
    # the stacked engine's archive resumes under the loop engine
    again = port_train.main(ARGV + ["--device", "cpu", "--resume", ck])
    assert again["acc_history"] == out["acc_history"]


def test_cli_scale_refusals(monkeypatch):
    for extra in (["--scale-reduction", "ordered"], ["--sim", "--scale"]):
        with pytest.raises(SystemExit):
            port_train.main(ARGV + extra + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(ARGV + ["--scale"])
