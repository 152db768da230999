"""The loop engine compiled (``repro_torch.fl.base`` / ``fl.engine`` through
``utils.graph.graphed``) and the packed mix's host reads, on the CPU.

* ``graph.check_capturable()`` over every compiled body of the loop
  engine: ``Task.value_and_grad``, the local step (masked, plain, with
  momentum 0.9), ``Task.accuracy``, ``Task.accuracy_stacked`` and the vmap
  local phase's stacked step — each body called directly, and every body a
  real round runs, loop and vmap, checked as it runs.
* The packed mix reads the device back at most twice per sender a round
  (one ``pack_tree``, one ``decode_tree``): a dispatch mode counts every op
  that waits for the card (``_local_scalar_dense``, ``tolist``, ``numpy``,
  ``nonzero``, ``masked_select`` and boolean indexing) around
  ``DisPFLStrategy.mix``, ``snapshot_message`` and ``mix_one``.
* A malformed leaf inside a payload tree is refused before anything is
  folded, by ``decode_tree``, ``packed_gossip_one``, ``packed_axpy`` and
  ``packed_accum_all``.
* The working-buffer trap: a replay writes the local step's result into its
  donated buffers; with that written back here on the CPU, every client's
  params after a local phase of clients 0..3, loop or vmap, equal the same
  phase run eagerly.
* The vmap phase's captures depend on the number of active clients and the
  batch shape, never on the phase's step count.
* The engine holds its clients' data on the device, copied there once.

Smallcnn, hw 8, width 4, K = 4: this file imports no jax.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import RoundEngine, make_strategy
from repro_torch.kernels import packed_accum as pa
from repro_torch.optim.sgd import SGDConfig, init_sgd
from repro_torch.sparse import ops
from repro_torch.sparse.packed import PackedSparse, pack_tree
from repro_torch.utils import graph
from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

pytestmark = pytest.mark.tier1

DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=12, n_test_per_client=8, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=2, local_epochs=1, batch_size=8, degree=2,
           eval_every=1, topology="ring")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: under the suite's parallel workers torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _clients():
    return build_federated_image_task(0, **DATA)[0]


def _engine(name="dispfl", local_exec="loop", **cfg):
    return RoundEngine(make_strategy(name), _task(), _clients(),
                       FLConfig(**{**CFG, **cfg}), local_exec=local_exec)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# every compiled body passes the capture check
# ---------------------------------------------------------------------------


def _batch(clients, k=0, n=8):
    c = clients[k]
    return torch.as_tensor(c.train_x[:n]), torch.as_tensor(c.train_y[:n])


def _body_case(name):
    """(fn, args) of one compiled body on a dispfl state."""
    eng = _engine()
    task, state, clients = eng.task, eng.state, eng.clients
    params, mask = state["params"][0], state["masks"][0]
    x, y = _batch(clients)
    lr = torch.full((), 0.05)
    if name == "value_and_grad":
        return task._vg, (params, x, y)
    if name.startswith("step"):
        opt = SGDConfig(momentum=0.9 if name == "step_momentum" else 0.0,
                        weight_decay=5e-4)
        m = None if name == "step_plain" else mask
        return task.local_step(opt), (params, init_sgd(params, opt), m, x,
                                      y, lr)
    if name == "accuracy":
        c = clients[1]
        return task._acc, (params, torch.as_tensor(c.test_x),
                           torch.as_tensor(c.test_y))
    stacked = tree_stack(state["params"])
    if name == "accuracy_stacked":
        from repro_torch.fl.base import stack_eval_arrays
        return task._acc_stacked, (stacked,
                                   *stack_eval_arrays(clients, "cpu"))
    assert name == "vmap_step"
    bx = torch.stack([_batch(clients, k)[0] for k in range(4)])
    by = torch.stack([_batch(clients, k)[1] for k in range(4)])
    alive = torch.tensor([True, True, True, False])
    opt = SGDConfig(momentum=0.9, weight_decay=5e-4)
    return task.local_step(opt, stacked=True), (
        stacked, init_sgd(stacked, opt), tree_stack(state["masks"]), bx, by,
        lr, alive)


@pytest.mark.parametrize("name", ["value_and_grad", "step_masked",
                                  "step_plain", "step_momentum", "accuracy",
                                  "accuracy_stacked", "vmap_step"])
def test_compiled_body_is_capturable(name):
    fn, args = _body_case(name)
    want = fn(*args)
    with graph.check_capturable():
        got = fn(*args)
    assert _equal(got, want)
    assert all(torch.isfinite(t).all() for t in tree_leaves(got))


@pytest.mark.parametrize("name,local_exec", [("dispfl", "loop"),
                                             ("dispfl", "vmap"),
                                             ("dpsgd", "loop")])
def test_rounds_run_every_compiled_body_capturably(monkeypatch, name,
                                                   local_exec):
    made = []

    def checked_graphed(fn, donate=()):
        def run(*args):
            with graph.check_capturable():
                return fn(*args)
        made.append(graph.Graphed(run, donate))
        return made[-1]

    monkeypatch.setattr(graph, "graphed", checked_graphed)
    eng = _engine(name, local_exec, momentum=0.9)
    eng.run()
    # value_and_grad, accuracy, accuracy_stacked, then the loop's step or
    # the vmap phase's stacked step: each built through ``graph.graphed``
    assert len(made) == 4
    assert list(eng.task._steps) == [(eng.strategy.opt,
                                      local_exec == "vmap")]


# ---------------------------------------------------------------------------
# host reads of the packed mix
# ---------------------------------------------------------------------------


class _CountReads(TorchDispatchMode):
    """Counts the ops that wait for the card: host reads, data-dependent
    shapes and boolean indexing (``tolist`` and ``numpy`` dispatch nothing:
    they are patched for the mode's span)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "nonzero", "masked_select") or (
                name in ("index", "index_put", "index_put_") and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ()) or ())):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        saved = self._saved = torch.Tensor.tolist, torch.Tensor.numpy

        def counted(i, what):
            def call(t, *a, **k):
                self.reads.append(what)
                return saved[i](t, *a, **k)
            return call

        torch.Tensor.tolist = counted(0, "tolist")
        torch.Tensor.numpy = counted(1, "numpy")
        return super().__enter__()

    def __exit__(self, *exc):
        torch.Tensor.tolist, torch.Tensor.numpy = self._saved
        return super().__exit__(*exc)


@pytest.mark.parametrize("payload_dtype", ["fp32", "fp16"])
def test_packed_mix_reads_twice_per_sender(payload_dtype):
    eng = RoundEngine(make_strategy("dispfl", payload_dtype=payload_dtype),
                      _task(), _clients(), FLConfig(**CFG), local_exec="loop")
    eng.run()
    strat, state = eng.strategy, eng.state
    ctx = eng._make_ctx(2)
    a = ctx.adjacency
    senders = {j for k in range(4) for j in range(4) if a[k, j] and j != k}
    count = _CountReads()
    with count:
        strat.mix(state, ctx)
    assert count.reads == ["tolist"] * (2 * len(senders))
    with count:
        msgs = {j: strat.snapshot_message(state, j) for j in (1, 3)}
    assert count.reads == ["tolist"] * (2 * len(senders) + 2)
    with count:
        strat.mix_one(state, 0, msgs, ctx)
    assert count.reads == ["tolist"] * (2 * len(senders) + 3)


# ---------------------------------------------------------------------------
# a malformed leaf inside a payload tree
# ---------------------------------------------------------------------------


def _malformed_tree():
    """A dispfl client's packed tree with one value missing from the
    payload of its third leaf."""
    eng = _engine()
    params, mask = eng.state["params"][1], eng.state["masks"][1]
    packed = pack_tree(params, mask)
    leaves, spec = tree_flatten(packed, is_leaf=lambda x: isinstance(
        x, PackedSparse))
    bad = leaves[2]
    leaves[2] = PackedSparse(bitmap=bad.bitmap, values=bad.values[:-1],
                             shape=bad.shape)
    return eng, tree_unflatten(leaves, spec)


def test_malformed_leaf_is_refused_before_any_fold(monkeypatch):
    eng, packed = _malformed_tree()
    folded = []
    plain = pa._fold_plain
    monkeypatch.setattr(pa, "_fold_plain",
                        lambda *a: folded.append(1) or plain(*a))
    own, own_mask = eng.state["params"][0], eng.state["masks"][0]
    before = tree_map(torch.clone, own)
    for call in (lambda: ops.decode_tree(packed),
                 lambda: ops.packed_gossip_one(own, own_mask, [packed]),
                 lambda: ops.packed_axpy(own, packed, 0.5)):
        with pytest.raises(ValueError, match="set bits"):
            call()
    assert folded == [] and _equal(own, before)


def test_fold_all_refusal_leaves_every_accumulator():
    rng = np.random.default_rng(3)
    folds = []
    for n, extra in ((300, 0), (1000, 1), (64, 0)):
        flags = torch.from_numpy(rng.random(n) < 0.5)
        from repro_torch.sparse.packed import pack_bits
        values = torch.randn(int(flags.sum()) + extra)
        folds.append((torch.randn(n), torch.rand(n), pack_bits(flags),
                      values, 0.75))
    before = [(num.clone(), den.clone()) for num, den, *_ in folds]
    with pytest.raises(ValueError, match="set bits"):
        pa.packed_accum_all(folds)
    for (num, den, *_), (n0, d0) in zip(folds, before):
        assert torch.equal(num, n0) and torch.equal(den, d0)
    # without the malformed payload every fold lands, in order
    good = [folds[0], folds[2]]
    pa.packed_accum_all(good)
    for (num, den, words, values, alpha), (n0, d0) in zip(good, [before[0],
                                                               before[2]]):
        want = pa.packed_accum_plain(n0.clone(), d0.clone(), words, values,
                                     alpha)
        assert torch.equal(num, want[0]) and torch.equal(den, want[1])


# ---------------------------------------------------------------------------
# the working-buffer trap
# ---------------------------------------------------------------------------


class _Donating(graph.Graphed):
    """On the CPU, what a replay does to donated arguments: each output the
    capture writes back into a donated argument is copied into its tensors,
    which are returned in the output's place."""

    writes = 0

    def __call__(self, *args):
        if graph.is_disabled():
            return self.fn(*args)
        out = graph._sorted(self.fn(*args))
        targets = self._donated_targets(args, out)
        leaves, spec = tree_flatten(out)
        for o, d in zip(leaves, targets):
            if d is not None:
                d.copy_(o)
                _Donating.writes += 1
        return tree_unflatten([o if d is None else d
                               for o, d in zip(leaves, targets)], spec)


@pytest.mark.parametrize("local_exec,momentum", [("loop", 0.0),
                                                 ("loop", 0.9),
                                                 ("vmap", 0.9)])
def test_local_phase_copies_out_of_working_buffers(monkeypatch, local_exec,
                                                   momentum):
    monkeypatch.setattr(graph, "graphed",
                        lambda fn, donate=(): _Donating(fn, donate))
    runs = []
    for eager in (True, False):
        eng = _engine(local_exec=local_exec, momentum=momentum)
        ctx = eng._make_ctx(0)
        if eager:
            with graph.disabled():
                eng.run_local_phase(ctx, range(4))
        else:
            eng.run_local_phase(ctx, range(4))
        runs.append(eng.state["params"])
    assert _Donating.writes > 0
    for k in range(4):
        assert _equal(runs[1][k], runs[0][k]), k
    # one set of buffers served all four clients, and no client holds them
    task_work = list(eng.task._work.values())
    assert len(task_work) == 1
    held = {id(t) for t in tree_leaves(task_work[0]["w"])}
    assert not any(id(t) in held for p in runs[1] for t in tree_leaves(p))


class _Signatures(graph.Graphed):
    """Records the input signature of every call (the key of a capture on
    the card) and runs the function eagerly."""

    def __init__(self, fn, donate=()):
        super().__init__(fn, donate)
        self.seen = set()

    def __call__(self, *args):
        self.seen.add(graph.signature(args))
        return self.fn(*args)


def test_vmap_captures_do_not_depend_on_step_count(monkeypatch):
    """One client a phase, as the asynchronous simulator runs it, then all
    four: the stacked step's signatures are one per (active clients, batch
    size), whatever each phase's step count."""
    monkeypatch.setattr(graph, "graphed", _Signatures)
    clients = build_federated_image_task(
        0, **{**DATA, "partition": "dirichlet", "alpha": 0.5})[0]
    eng = RoundEngine(make_strategy("dispfl"), _task(), clients,
                      FLConfig(**CFG), local_exec="vmap")
    bs = [min(CFG["batch_size"], c.n_train) for c in clients]
    steps = [-(-c.n_train // b) for c, b in zip(clients, bs)]
    assert len(set(steps)) > 1          # ragged: the phase lengths differ
    ctx = eng._make_ctx(0)
    for k in range(4):
        eng.run_local_phase(ctx, [k])
    eng.run_local_phase(ctx, range(4))
    ((_, stacked), step), = eng.task._steps.items()
    assert stacked
    assert len(step.seen) == len({(1, b) for b in bs} | {(4, min(bs))})
    assert len(eng.task._work) == len(step.seen)


def test_engine_holds_client_data_on_device():
    clients = _clients()
    eng = _engine()
    held = [(c.train_x, c.test_x) for c in eng.clients]
    for c, src in zip(eng.clients, clients):
        for f in ("train_x", "train_y", "test_x", "test_y"):
            t = getattr(c, f)
            assert isinstance(t, torch.Tensor) and t.device == eng.device
            assert np.array_equal(t.numpy(), getattr(src, f))
        # local_sgd takes them as they are: no copy a phase
        assert eng.task.as_tensor(c.train_x) is c.train_x
    eng.run()
    assert all(c.train_x is x and c.test_x is t
               for c, (x, t) in zip(eng.clients, held))
