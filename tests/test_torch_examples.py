"""The port's examples (``examples/torch_*.py``) on the CPU at reduced
sizes, through each one's ``main([...])``, with their analytic rows held
equal to the reference library's at the same sizes:

* comm MB and GFLOP/round of each method of ``torch_quickstart``,
  ``torch_heterogeneous_clients`` and ``torch_custom_strategy``, against
  the reference's own strategies' ``round_comm`` / ``round_flops`` (or
  ``repro.core.accounting``) over ``repro.core.topology``'s adjacency.
  DisPFL's masks hold their ERK budgets exactly after each round's evolve,
  so its comm is the reference's on masks of those budgets; a random
  draw's nnz (D-PSGD-FT's 20% mask) is taken from the port's own mask;
* the one-message value, wire and dense bytes of ``torch_async_gossip``
  and the codec frames of ``torch_scale_mesh``, each the reference
  codec's for the same state;
* the served stores' ``bytes_at_rest`` of ``torch_serve_personalized``,
  each the reference ``ModelStore``'s holding the same users.

Accuracies are not compared: the initial draw is ``jax.random`` in the
reference.  Every example refuses to start without a GPU unless
``--device cpu`` is given.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import accounting as ref_acc
from repro.core.evolve import layer_nnz_budgets as ref_budgets
from repro.core.masks import erk_densities_for_params as ref_erk
from repro.core.topology import make_adjacency as ref_adjacency
from repro.data import build_federated_image_task as ref_build
from repro.fl import FLConfig as RefCfg
from repro.fl import make_cnn_task as ref_task
from repro_torch.checkpoint.npz import to_numpy
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.tier1

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
NAMES = ["quickstart", "custom_strategy", "heterogeneous_clients",
         "async_gossip", "scale_mesh", "serve_personalized", "train_e2e"]
SMALL = ["--device", "cpu", "--clients", "4", "--rounds", "1", "--epochs",
         "1", "--samples-per-class", "8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: under the suite's parallel workers torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return tree_map(to_numpy, tree)


def _ref_rows(method, data_kw, task_kw, cfg_kw, params):
    """The reference's per-round comm and FLOPs means for ``method`` at
    these sizes: its accounting (``repro.core.accounting``) over
    ``repro.core.topology``'s adjacency of each round, with each client's
    nnz from the reference's ERK budgets for ``params``' shapes (a dispfl
    mask holds them exactly after each round's evolve)."""
    clients, _ = ref_build(**data_kw)
    cfg = RefCfg(**cfg_kw)
    task = ref_task(**task_kw)
    n_samples = int(np.mean([c.n_train for c in clients]))
    k = cfg.n_clients
    n = sum(np.size(x) for x in jax.tree.leaves(params))
    if method == "dispfl":
        dens = [ref_erk(params, cfg.client_density(i)) for i in range(k)]
        fixed = sum(np.size(x) for x in jax.tree.leaves(params)
                    if np.ndim(x) < 2)
        nnz = [sum(ref_budgets(params, d).values()) + fixed for d in dens]
        mean = {p: float(np.mean([d[p] for d in dens])) for p in dens[0]}
        flops = ref_acc.sparse_training_flops(
            task.fwd_flops, mean, n_samples, cfg.local_epochs,
            mask_search_batches=1, batch_size=cfg.batch_size)
    else:
        nnz = [n] * k
        flops = ref_acc.sparse_training_flops(
            task.fwd_flops, {p: 1.0 for p in task.fwd_flops}, n_samples,
            cfg.local_epochs, mask_search_batches=0,
            batch_size=cfg.batch_size)
    if method == "local":
        comm = [ref_acc.centralized_comm(0, [0], n).busiest_mb]
    else:
        comm = [ref_acc.decentralized_comm(
            ref_adjacency(cfg.topology, k, t, cfg.degree, cfg.seed,
                          cfg.drop_prob), nnz, n).busiest_mb
            for t in range(cfg.rounds)]
    return float(np.mean(comm)), float(flops.per_round_flops)


def _params(width, hw=16):
    """A smallcnn's params as numpy (the packages' shapes are equal)."""
    from repro_torch.fl import make_cnn_task
    task = make_cnn_task("smallcnn", 10, hw, width=width, device="cpu")
    return _np(task.init_fn(torch.Generator().manual_seed(0)))


QUICK_DATA = dict(seed=0, n_clients=4, partition="pathological",
                  classes_per_client=2, n_train_per_class=8,
                  n_test_per_client=40, hw=16, noise=0.8)
QUICK_CFG = dict(n_clients=4, rounds=1, local_epochs=1, batch_size=32,
                 degree=4, density=0.5, eval_every=2)


def test_quickstart_rows_equal_the_reference(capsys):
    out = _example("quickstart").main(SMALL)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split() == ["method", "acc", "comm(MB)", "GFLOP/round"]
    assert [r.split()[0] for r in printed[1:]] == list(out) == [
        "local", "dpsgd", "dpsgd_ft", "dispfl"]
    params = _params(12)
    for method, res in out.items():
        want = _ref_rows(method, QUICK_DATA,
                         dict(kind="smallcnn", n_classes=10, hw=16, width=12),
                         QUICK_CFG, params)
        assert (res.comm_busiest_mb, res.flops_per_round) == want, method
        assert 0.0 <= res.final_acc <= 1.0
    assert out["local"].comm_busiest_mb == 0.0
    assert 0 < out["dispfl"].comm_busiest_mb < out["dpsgd"].comm_busiest_mb


def test_heterogeneous_rows_equal_the_reference():
    from repro_torch.data import build_federated_image_task
    from repro_torch.fl import FLConfig, make_cnn_task, make_strategy
    from repro_torch.utils.tree import tree_nnz
    levels = [0.2, 0.4, 0.6, 0.8, 1.0]
    out = _example("heterogeneous_clients").main(
        ["--device", "cpu", "--clients", "5", "--rounds", "1", "--epochs",
         "1", "--samples-per-class", "8"])
    data = dict(seed=1, n_clients=5, partition="pathological",
                classes_per_client=2, n_train_per_class=8, hw=16)
    task_kw = dict(kind="smallcnn", n_classes=10, hw=16, width=12)
    cfg_kw = dict(n_clients=5, rounds=1, local_epochs=1, batch_size=32,
                  degree=4, capacities=levels, eval_every=4)
    res = out["dispfl"]
    params = _params(12)
    assert (res.comm_busiest_mb, res.flops_per_round) == _ref_rows(
        "dispfl", data, task_kw, cfg_kw, params)
    # D-PSGD-FT's 20% mask is a random draw: its nnz is the port's own
    res_d = out["dpsgd_ft"]
    task = make_cnn_task("smallcnn", 10, 16, width=12, device="cpu")
    strat = make_strategy("dpsgd_ft", param_fraction=0.2)
    strat.init_state(task, build_federated_image_task(**data)[0],
                     FLConfig(**cfg_kw))
    n_coords = sum(np.size(x) for x in jax.tree.leaves(params))
    cfg = RefCfg(**cfg_kw)
    adj = ref_adjacency(cfg.topology, 5, 0, cfg.degree, cfg.seed,
                        cfg.drop_prob)
    want = ref_acc.decentralized_comm(adj, [tree_nnz(strat.mask)] * 5,
                                      n_coords).busiest_mb
    assert res_d.comm_busiest_mb == want
    # its FLOPs: training at the mask's ERK densities, no mask search
    flops = ref_acc.sparse_training_flops(
        ref_task(**task_kw).fwd_flops, ref_erk(params, 0.2),
        int(np.mean([c.n_train for c in ref_build(**data)[0]])), 1,
        mask_search_batches=0, batch_size=32).per_round_flops
    assert res_d.flops_per_round == flops
    assert len(res.final_accs) == 5


def test_custom_strategy_rows_equal_the_reference_accounting():
    res = _example("custom_strategy").main(
        ["--device", "cpu", "--clients", "4", "--rounds", "2", "--epochs",
         "1", "--samples-per-class", "8"])
    data = dict(seed=0, n_clients=4, partition="pathological",
                classes_per_client=2, n_train_per_class=8,
                n_test_per_client=30, hw=16, noise=0.8)
    clients, _ = ref_build(**data)
    task = ref_task("smallcnn", n_classes=10, hw=16, width=8)
    cfg = RefCfg(n_clients=4, rounds=2, local_epochs=1, batch_size=32,
                 degree=3, eval_every=2)
    n = sum(np.size(x) for x in jax.tree.leaves(_params(8)))
    comm = [ref_acc.decentralized_comm(
        ref_adjacency(cfg.topology, 4, t, cfg.degree, cfg.seed,
                      cfg.drop_prob), [n] * 4, n).busiest_mb
        for t in range(2)]
    flops = ref_acc.sparse_training_flops(
        task.fwd_flops, {k: 1.0 for k in task.fwd_flops},
        int(np.mean([c.n_train for c in clients])), 1,
        mask_search_batches=0, batch_size=32).per_round_flops
    assert res.comm_busiest_mb == float(np.mean(comm))
    assert res.flops_per_round == flops
    assert 0.0 <= res.final_acc <= 1.0


def test_async_gossip_message_bytes_equal_the_reference_codec():
    from repro.sim import measure_payload as ref_measure
    from repro.sparse import pack_tree as ref_pack_tree
    from repro.utils.tree import tree_bytes as ref_tree_bytes
    from repro_torch.fl import FLConfig, make_cnn_task
    from repro_torch.fl.dispfl import dispfl_state
    out = _example("async_gossip").main(SMALL)
    # the message the example measured: client 0's before the first round
    eng = out["engines"]["sync"]
    params, masks = dispfl_state(eng.task, eng.cfg)
    p0, m0 = _np(params[0]), _np(masks[0])
    val_b, wire_b = ref_measure({"packed": ref_pack_tree(p0, m0)})
    assert out["message"] == (val_b, wire_b, ref_tree_bytes(p0))
    assert wire_b < ref_tree_bytes(p0)
    for eng in out["engines"].values():
        assert eng.stats.total_mb > 0


def test_scale_mesh_frames_equal_the_reference_codec():
    from repro.core.masks import erk_densities_for_params as ref_erk
    from repro.core.evolve import layer_nnz_budgets as ref_budgets
    from repro.sparse import encoded_nbytes as ref_nbytes
    from repro.sparse import pack_tree as ref_pack_tree
    out = _example("scale_mesh").main(
        ["--device", "cpu", "--clients", "8", "--rounds", "1",
         "--samples-per-class", "8"])
    eng = out["engine"]
    state = eng.state
    params = [_np(tree_map(lambda x: x[k], state["params"]))
              for k in range(8)]
    stacked = eng.adapter.stacked_masks(state)
    masks = [_np(tree_map(lambda x: x[k], stacked)) for k in range(8)]
    want = [ref_nbytes(ref_pack_tree(p, m)) for p, m in zip(params, masks)]
    assert out["frames"] == want
    # after the round's evolve every mask holds its ERK budget exactly
    budgets = ref_budgets(params[0], ref_erk(params[0], 0.5))
    held = sum(budgets.values()) + sum(
        np.size(x) for p, x in jax.tree_util.tree_leaves_with_path(params[0])
        if np.ndim(x) < 2)
    n_coords = sum(np.size(x) for x in jax.tree.leaves(params[0]))
    assert want == [ref_acc.message_bytes(held, n_coords, with_bitmap=True)
                    ] * 8


def test_serve_personalized_bytes_at_rest_equal_the_reference_store():
    from repro.serve import ModelStore as RefStore
    from repro_torch.launch import serve as cli
    out = _example("serve_personalized").main(
        ["--device", "cpu", "--users", "6", "--requests", "12",
         "--arch-users", "2", "--arch-requests", "3"])
    for name, users, argv in (
            ("mlp", 6, ["--model", "mlp", "--users", "6", "--density",
                        "0.3"]),
            ("gemma3-1b", 2, ["--model", "gemma3-1b", "--users", "2",
                              "--rows", "1"])):
        args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
        model = cli.build_model(args.model, args.rows)
        store = cli.build_store(args, model, torch.device("cpu"))
        ref = RefStore(_np(store.base), cache_size=2)
        for u in range(users):
            params, masks = store.get(u)
            ref.put(u, _np(params), _np(masks))
        assert out[name]["store_bytes_at_rest"] == \
            ref.total_bytes_at_rest() == store.total_bytes_at_rest()
        assert out[name]["requests"] > 0


def test_train_e2e_runs_lm_in_process():
    out = _example("train_e2e").main(
        ["--device", "cpu", "--clients", "2", "--steps", "2", "--rounds",
         "2", "--seq", "32"])
    assert out["arch"] == "qwen3-8b-smoke" and "improved" in out


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_to_start_without_a_gpu(name, monkeypatch):
    """Defaults on CUDA; with no GPU and no ``--device cpu``, the
    example raises as ``setup_device`` does (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"serve_personalized": ["--users", "2"],
            "train_e2e": ["--steps", "1"]}.get(name, ["--clients", "2"])
    with pytest.raises(RuntimeError, match="cpu"):
        _example(name).main(argv)


def test_examples_import_only_the_port():
    import ast
    for name in NAMES:
        src = open(os.path.join(EXAMPLES, f"torch_{name}.py")).read()
        for node in ast.walk(ast.parse(src)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not any(m.split(".")[0] in ("repro", "jax")
                           for m in mods), (name, mods)
