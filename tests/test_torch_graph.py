"""Compiled steps (``repro_torch.utils.graph``): the CPU check that each
captured step body can be captured, ``graphed``'s argument rules and CPU
behaviour, and, on the card (``cuda``-marked, skipped here), graphed
replays against the same steps run eagerly.

The CPU check (``check_capturable``) refuses host reads, data-dependent
shapes and tensors built from host data inside a step: what a capture on
the card refuses or bakes in.  It cannot see a Python number a step bakes
in; only the card tests (replays bit-equal to eager with changing
per-call values) show that.  This file imports torch and the port only,
so the card tests run on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graph.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import InputShape
from repro_torch.core.topology import make_adjacency, max_in_degree
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import make_strategy
from repro_torch.kernels import build
from repro_torch.kernels import gossip_avg as ga
from repro_torch.kernels import prune_regrow as pr
from repro_torch.launch import steps, train
from repro_torch.launch.dryrun import materialize
from repro_torch.models import bind
from repro_torch.scale.engine import ScaleEngine
from repro_torch.scale.stacked import (
    in_neighbour_index,
    masked_gossip_stacked,
    stacked_evolve_exact,
    stacked_prune_regrow_threshold,
)
from repro_torch.utils import graph
from repro_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.tier1

ARCH = "gemma3-1b"          # chip_smoke phase 18's arch, at smoke width
K, S = 2, 32           # 32 tokens: the smoke window (16) bands
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=12, n_test_per_client=8, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=1, batch_size=8, degree=2,
           eval_every=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: under the suite's parallel workers torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checked(fn):
    def run(*args):
        with graph.check_capturable():
            return fn(*args)
    return run


def _lm_inputs(mode, device="cpu"):
    cfg = configs.SMOKE_ARCHS[ARCH]
    api = bind(cfg)
    plan = steps.ScalePlan(cfg, InputShape("t", S, K, mode), K, 1)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tree_map(lambda x: x * 0.02, materialize(
        steps.abstract_params(api, plan), cfg.vocab, device, gen))
    batch = materialize(steps.input_specs(api, plan), cfg.vocab, device, gen)
    masks = materialize(steps.abstract_masks(params), cfg.vocab, device, gen)
    params = tree_map(lambda w, m: w * m, params, masks)
    return api, plan, params, masks, batch, gen


# ---------------------------------------------------------------------------
# the CPU capturability check over every captured step body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gossip", ["einsum", "ppermute"])
def test_train_step_is_capturable(gossip):
    api, plan, params, masks, batch, _ = _lm_inputs("train")
    step = steps.make_train_step(api, plan, gossip)
    args = (params, masks, batch, torch.ones(K, K), torch.tensor(0.01))
    got = _checked(step)(*args)
    want = step(*args)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))


def test_mask_update_step_is_capturable():
    api, plan, params, masks, batch, _ = _lm_inputs("train")
    step = steps.make_mask_update_step(api, plan)
    got = _checked(step)(params, masks, batch, torch.tensor(0.25))
    want = step(params, masks, batch, 0.25)      # a float, eagerly
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))


def test_prefill_and_decode_steps_are_capturable():
    api, plan, params, _, batch, gen = _lm_inputs("prefill")
    cache = materialize(steps.abstract_cache(api, plan),
                        configs.SMOKE_ARCHS[ARCH].vocab, "cpu", gen)
    logits, cache = _checked(steps.make_prefill_step(api, plan))(
        params, batch, cache)
    tok = torch.argmax(logits[:, :, -1], -1)[..., None].to(torch.int32)
    pos = torch.full((K,), S - 1, dtype=torch.int32)
    nxt, _ = _checked(steps.make_decode_step(api, plan))(
        params, {"tokens": tok, "pos": pos}, cache)
    assert nxt.shape == (K, 1) and nxt.dtype == torch.int32


def test_lm_loop_step_is_capturable(monkeypatch):
    made = []

    def checked_graphed(fn, donate=()):
        made.append(donate)
        return graph.Graphed(_checked(fn), donate)

    monkeypatch.setattr(graph, "graphed", checked_graphed)
    args = train.parse_args(["lm", "--device", "cpu", "--arch", "qwen3-8b",
                             "--clients", "2", "--rounds", "2", "--steps",
                             "2", "--seq", "16", "--batch-size", "2",
                             "--d-model", "32", "--tokens-per-client",
                             "512"])
    cfg = train.lm_config(args)
    params, masks = train.init_lm_clients(args, cfg, torch.device("cpu"))
    out, _ = train.lm_loop(args, cfg, params, masks, torch.device("cpu"))
    assert made == [(0, 1)] and len(out["loss_history"]) == 2


@pytest.mark.parametrize("name,reduction", [("dispfl", "ordered"),
                                            ("dispfl_anneal", "einsum"),
                                            ("dpsgd", "ordered")])
def test_scale_round_step_is_capturable(name, reduction):
    eng = ScaleEngine(make_strategy(name),
                      make_cnn_task("smallcnn", 10, 8, width=4,
                                    device="cpu"),
                      build_federated_image_task(0, **DATA)[0],
                      FLConfig(**{**CFG, "rounds": 2}), reduction=reduction)
    eng.run()
    assert eng.step_compiles == 0 and eng._round_step.captures == 0
    assert set(eng.phase_s[0]) == {"inputs", "mix", "local", "evolve",
                                   "eval"}
    # the compiled step's body on a further round's inputs: capturable,
    # and the phases the CPU runs one by one
    inp = eng._round_inputs(eng._make_ctx(2))
    with graph.check_capturable():
        got = eng._round_step(eng.state, inp)
    want = eng.state
    for _, phase in eng._phase_fns:
        want = phase(want, inp)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t.view(
        torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_index_has_one_shape_and_its_pads_are_exact(dtype):
    """Random topology, K=8, degree 3, with drops: every round's index is
    (8, 4), so one capture serves the run; the pad rows (-0.0) leave every
    sum's bits as the real rows alone give them, -0.0 results included."""
    k, degree = 8, 3
    width = 1 + max_in_degree("random", k, degree)
    gen = torch.Generator().manual_seed(0)
    m = (torch.rand(k, 3, 64, generator=gen) < 0.5).to(dtype)
    w = (torch.randn(k, 3, 64, generator=gen) * m).to(dtype)
    w[:, 0] = -0.0                     # a coordinate that sums to -0.0
    m[:, 0] = 1.0
    degrees = set()
    for t in range(12):
        adj = make_adjacency("random", k, t, degree, seed=1, drop_prob=0.3)
        index = in_neighbour_index(adj, width)
        assert index.shape == (k, width) and index.dtype == torch.int64
        degrees.add(tuple(int(r) for r in (index < k).sum(1)))
        got = masked_gossip_stacked({"a": w}, {"a": m}, index,
                                    reduction="ordered")["a"]
        for r in range(k):
            rows = [r] + [j for j in range(k) if adj[r, j] > 0 and j != r]
            want = ga.gossip_avg_plain([w[j] for j in rows],
                                       [m[j] for j in rows], m[r])
            assert torch.equal(_bits(got[r]), _bits(want))
        assert torch.equal(_bits(got[:, 0]),
                           _bits(torch.full_like(got[:, 0], -0.0)))
    assert len(degrees) > 1               # the in-degrees did change
    with pytest.raises(ValueError, match="width"):
        in_neighbour_index(np.ones((k, k)), width)


def test_every_wrapper_module_counts_its_launches():
    """Each kernel wrapper module that keeps ``LAUNCHES`` joined the
    registry ``graphed`` reads, and a launch no wrapper counted raises."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels
    mods = [importlib.import_module(f"repro_torch.kernels.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__)]
    with_counts = {m.__name__ for m in mods if hasattr(m, "LAUNCHES")}
    assert with_counts == {m.__name__ for m in build.COUNTED}
    assert {"repro_torch.kernels.gossip_avg",
            "repro_torch.kernels.prune_regrow"} <= with_counts
    before = build.launch_counts()
    ga.LAUNCHES += 2
    ga.LAUNCHES_BY_ENTRY["gossip_avg_f32"] += 2
    build.CALLS_BY_ENTRY["gossip_avg_f32"] = build.CALLS_BY_ENTRY.get(
        "gossip_avg_f32", 0) + 2
    delta = build.launch_count_delta(before, build.launch_counts())
    build.add_launch_counts(delta, -1)
    assert build.launch_count_delta(before, build.launch_counts()) == {}
    build.check_counted(delta)
    build.add_launch_counts(delta)            # a replay
    assert ga.LAUNCHES == before["repro_torch.kernels.gossip_avg",
                                 "LAUNCHES"] + 2
    build.add_launch_counts(delta, -1)
    with pytest.raises(RuntimeError, match="counts_launches"):
        build.check_counted({("repro_torch.kernels.build",
                              "CALLS_BY_ENTRY"): {"new_entry_f32": 1}})


# ---------------------------------------------------------------------------
# the check itself, and graphed's rules on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plant", ["item", "tolist", "bool_gather",
                                   "nonzero", "tensor", "as_tensor"])
def test_check_refuses_planted_host_ops(plant):
    x = torch.arange(6.0)
    body = {"item": lambda: x.sum().item(),
            "tolist": lambda: x.tolist(),
            "bool_gather": lambda: x[x > 2],
            "nonzero": lambda: torch.nonzero(x),
            "tensor": lambda: x + torch.tensor(2.0),
            "as_tensor": lambda: x * torch.as_tensor(np.ones(6))}[plant]
    with pytest.raises(graph.CaptureError):
        with graph.check_capturable():
            body()
    body()                                   # the patch is undone
    with graph.check_capturable():           # device factories pass
        x * torch.full((), 2.0) + x[torch.arange(6) % 3]


@pytest.mark.parametrize("bad", [0.01, 3, True, np.float32(0.5),
                                 np.ones(2)])
def test_graphed_refuses_host_numbers(bad):
    step = graph.graphed(lambda w, lr: w * lr)
    with pytest.raises(TypeError, match="bake"):
        step(torch.ones(3), bad)


def test_graphed_is_the_eager_step_on_the_cpu():
    api, plan, params, masks, batch, _ = _lm_inputs("train")
    step = steps.make_train_step(api, plan)
    g = graph.graphed(step, donate=(0,))
    lr = torch.tensor(0.05)
    adj = torch.ones(K, K)
    got = g(params, masks, batch, adj, lr)
    want = step(params, masks, batch, adj, lr)
    assert g.captures == g.replays == 0
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    with graph.disabled():
        assert graph.is_disabled()
    assert not graph.is_disabled()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc to build the kernels); "
                    "torch.cuda.is_available() is False here")
    from repro_torch.device import setup_device
    return setup_device("cuda")


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(la, lb))


def _kernel_step(w, m, g, index, lr, counts, rate):
    """Both gossip and prune/regrow kernels, a masked update at ``lr``,
    the exact evolve at ``counts`` and the threshold one at ``rate``."""
    w = masked_gossip_stacked(w, m, index, reduction="ordered")
    w = tree_map(lambda a, b, c: (a - lr * b * c) * c, w, g, m)
    m2, w = stacked_evolve_exact(w, m, g, {"a": (counts[0], counts[1])})
    m3, w = stacked_prune_regrow_threshold(
        w, m2, g, rate, 0.5, sparsifiable=lambda t: t.dim() == 2)
    return w, m3


@pytest.mark.cuda
def test_graphed_replays_equal_eager_with_changing_scalars(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    k, n = 4, 4096
    m = {"a": (torch.rand(k, n, generator=gen, device=cuda_device) < 0.5)
         .float()}
    w0 = {"a": torch.randn(k, n, generator=gen, device=cuda_device) * m["a"]}
    g = {"a": torch.randn(k, n, generator=gen, device=cuda_device)}
    step = graph.graphed(_kernel_step, donate=(0,))
    w = tree_map(torch.clone, w0)
    ga.LAUNCHES = pr.LAUNCHES = 0
    # another topology and in-degree each call, in an index of one width:
    # one capture serves all
    for i, (hops, lr, keep, rate) in enumerate((((1, 2), 0.1, 1500, 0.25),
                                                ((3,), 0.05, 1400, 0.3),
                                                ((1, 2, 3), 0.02, 1600, 0.1))):
        adj = np.eye(k, dtype=np.float32)
        for r in range(k):
            adj[r, [(r + h) % k for h in hops]] = 1.0
        args = (in_neighbour_index(adj, k, cuda_device),
                torch.tensor(lr, device=cuda_device),
                torch.tensor([keep, 2048 - keep], device=cuda_device),
                torch.tensor(rate, device=cuda_device))
        with graph.disabled():
            want_w, want_m = _kernel_step(w, m, g, *args)
        before = (ga.LAUNCHES, pr.LAUNCHES)
        got_w, got_m = step(w, m, g, *args)
        torch.cuda.synchronize()
        assert got_w["a"] is w["a"]                       # donated: in place
        assert _bits_equal(got_w, want_w) and _bits_equal(got_m, want_m)
        if i:                                   # a replay counts as eager
            assert (ga.LAUNCHES - before[0], pr.LAUNCHES - before[1]) == (
                k, 1)
    assert step.captures == 1 and step.replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("clients,topology,degree", [(4, "fc", 2),
                                                     (8, "random", 3)])
def test_scale_engine_captures_once_and_equals_eager(cuda_device, clients,
                                                     topology, degree):
    """At random topology the in-degrees change between rounds; the
    index's fixed width keeps one capture."""
    def engine():
        return ScaleEngine(make_strategy("dispfl"),
                           make_cnn_task("smallcnn", 10, 8, width=4,
                                         device="cuda"),
                           build_federated_image_task(
                               0, **{**DATA, "n_clients": clients})[0],
                           FLConfig(**{**CFG, "n_clients": clients,
                                       "topology": topology,
                                       "degree": degree}),
                           reduction="ordered")

    eager = engine()
    with graph.disabled():
        ga.LAUNCHES = 0
        eager.run()
        per_round = ga.LAUNCHES // CFG["rounds"]
    graphed_eng = engine()
    ga.LAUNCHES = 0
    graphed_eng.run()
    assert graphed_eng.step_compiles == 1
    assert graphed_eng._round_step.captures == 1
    # round 0 warms up eagerly and replays; rounds 1-2 replay
    assert ga.LAUNCHES == per_round * (CFG["rounds"] + 1)
    assert _bits_equal(graphed_eng.state, eager.state)
    assert graphed_eng._comm == eager._comm
    assert graphed_eng._flops == eager._flops
    assert set(graphed_eng.phase_s[0]) == {"inputs", "step", "eval"}


@pytest.mark.cuda
def test_failing_capture_raises(cuda_device):
    def host_read(x):
        return x * float(x.sum())

    step = graph.graphed(host_read)
    with pytest.raises(RuntimeError):
        step(torch.ones(4, device=cuda_device))
    assert step.captures == 0
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=cuda_device).sum()) == 2.0
