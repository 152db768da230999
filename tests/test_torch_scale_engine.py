"""The port's ``ScaleEngine`` against the reference's ``repro.scale``, on the
CPU, each run from one reference archive: the three reference runs
(``ref_runs``, each computed once), the ordered masks against the port's
loop engine, checkpoint interchange, the stacked eval and the snapshot
messages.

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

from repro.data import build_federated_image_task as ref_build
from repro.fl import Checkpointer as RefCheckpointer
from repro.fl import FLConfig as RefFLConfig
from repro.fl import RoundEngine as RefRoundEngine
from repro.fl import make_cnn_task as ref_make_task
from repro.fl import make_strategy as ref_make_strategy
from repro.fl.base import evaluate_clients_stacked as ref_eval_stacked
from repro.scale import ScaleEngine as RefScaleEngine
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import (
    FLConfig,
    evaluate_clients,
    evaluate_clients_stacked,
    make_cnn_task,
)
from repro_torch.fl.engine import RoundEngine, make_strategy
from repro_torch.scale import (
    ScaleEngine,
    fold_stacked,
    stacked_state_from_numpy,
)
from repro_torch.sparse.packed import words_to_numpy
from repro_torch.utils.tree import tree_leaves_with_path
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


def _port_task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _port_clients():
    return build_federated_image_task(0, **DATA)[0]


# ---------------------------------------------------------------------------
# stacked primitives from numpy inputs
# ---------------------------------------------------------------------------


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


RUNS = {"dispfl-ordered": ("dispfl", "ordered"),
        "dispfl-einsum": ("dispfl", "einsum"),
        "dispfl_anneal-ordered": ("dispfl_anneal", "ordered")}


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """Each reference ScaleEngine run once: its round-0 archive, its
    per-round metrics and stacked states, and (ordered dispfl) the archive
    after round 2 — computed on first use."""
    d = tmp_path_factory.mktemp("ref_scale")
    clients = ref_build(0, **DATA)[0]
    task = ref_make_task("smallcnn", 10, 8, width=4)
    cache = {}

    def get(key):
        if key not in cache:
            name, reduction = RUNS[key]
            mid = str(d / f"{key}-r2.npz")
            eng = RefScaleEngine(ref_make_strategy(name), task, clients,
                                 RefFLConfig(**CFG), reduction=reduction,
                                 callbacks=[_SaveAt(mid, 1)])
            start = str(d / f"{key}-r0.npz")
            eng.save(start)
            rounds = [(m.to_dict(), _ref_np(eng.state))
                      for m in eng.rounds()]
            cache[key] = dict(start=start, mid=mid, rounds=rounds,
                              result=eng.result(), engine=eng)
        return cache[key]

    return get


class _SaveAt(RefCheckpointer):
    """Save once, after round ``at`` (0-based)."""

    def __init__(self, path, at):
        super().__init__(path)
        self.at = at

    def on_round_end(self, engine, metrics):
        if metrics.round == self.at:
            engine.save(self.path)

    def on_run_end(self, engine):
        pass


def _port_scale(name, reduction, **kw):
    return ScaleEngine(make_strategy(name), _port_task(), _port_clients(),
                       FLConfig(**CFG), reduction=reduction, **kw)


@pytest.mark.parametrize("key", list(RUNS))
def test_scale_engine_matches_reference_from_one_archive(ref_runs, key):
    ref = ref_runs(key)
    name, reduction = RUNS[key]
    port = _port_scale(name, reduction).restore(ref["start"])
    n = 0
    for (want, want_state), got in zip(ref["rounds"], port.rounds()):
        got = got.to_dict()
        for d in (want, got):
            d.pop("wall_s")
        for field in ("acc_mean", "acc_std"):
            np.testing.assert_allclose(got.pop(field), want.pop(field),
                                       rtol=0, atol=ACC_ATOL)
        assert got == dict(want)             # comm rows, FLOPs, lr, rate
        got_state = _port_np(port.state)
        for p, x in want_state.items():
            if p.startswith("masks"):
                np.testing.assert_array_equal(x, got_state[p], err_msg=p)
            else:
                np.testing.assert_allclose(x, got_state[p], rtol=0,
                                           atol=PARAM_ATOL, err_msg=p)
        n += 1
    assert n == CFG["rounds"]
    np.testing.assert_allclose(port.result().final_accs,
                               ref["result"].final_accs, rtol=0, atol=ACC_ATOL)
    assert port.step_compiles == 0
    assert port.scale_obs.snapshot() == {"step_calls": 3, "step_compiles": 0}
    assert len(port.scale_series.series("step_calls", kind="counter")) == 3
    assert set(port.phase_s[0]) == {"inputs", "mix", "local", "evolve",
                                    "eval"}


def test_ordered_masks_equal_port_loop_engine(ref_runs):
    start = ref_runs("dispfl-ordered")["start"]
    scale = _port_scale("dispfl", "ordered").restore(start)
    loop = RoundEngine(make_strategy("dispfl"), _port_task(), _port_clients(),
                       FLConfig(**CFG), local_exec="loop").restore(start)
    for a, b in zip(scale.rounds(), loop.rounds()):
        da, db = a.to_dict(), b.to_dict()
        for d in (da, db):
            d.pop("wall_s")
        assert da == db
        for k in range(CFG["n_clients"]):
            for (p, x), (_, y) in zip(
                    tree_leaves_with_path(scale.adapter.unstack_state(
                        scale.state)["masks"][k]),
                    tree_leaves_with_path(loop.state["masks"][k])):
                assert torch.equal(x, y), (a.round, k, p)
    for x, y in zip(scale.adapter.eval_params(scale.state),
                    loop.state["params"]):
        for (p, u), (_, v) in zip(tree_leaves_with_path(x),
                                  tree_leaves_with_path(y)):
            torch.testing.assert_close(u, v, rtol=0, atol=PARAM_ATOL)


def test_checkpoints_interchange_with_reference(ref_runs, tmp_path):
    """Reference archive -> port: resuming the reference ScaleEngine's
    round-2 archive finishes on the reference's masks.  Port archive ->
    reference: both of its engines load the port ScaleEngine's archive
    with every leaf and history bit-equal."""
    ref = ref_runs("dispfl-ordered")
    port = _port_scale("dispfl", "ordered").restore(ref["mid"])
    assert port._next_round == 2
    for _ in port.rounds():
        pass
    want = ref["rounds"][-1][1]
    got = _port_np(port.state)
    for p, x in want.items():
        if p.startswith("masks"):
            np.testing.assert_array_equal(x, got[p], err_msg=p)
        else:
            np.testing.assert_allclose(x, got[p], rtol=0, atol=PARAM_ATOL)
    path = str(tmp_path / "port.npz")
    port.save(path)
    ref_clients = ref_build(0, **DATA)[0]
    task = ref_make_task("smallcnn", 10, 8, width=4)
    for eng in (RefRoundEngine(ref_make_strategy("dispfl"), task, ref_clients,
                               RefFLConfig(**CFG), local_exec="loop"),
                RefScaleEngine(ref_make_strategy("dispfl"), task, ref_clients,
                               RefFLConfig(**CFG), reduction="ordered")):
        eng.restore(path)
        assert eng._next_round == CFG["rounds"]
        assert eng._acc_history == port._acc_history
        assert eng._comm == port._comm
        state = _ref_np(eng.state)
        if type(eng) is RefRoundEngine:       # per-client lists
            state = _ref_np({k: jax.tree.map(lambda *xs: np.stack(xs), *v)
                             for k, v in eng.state.items()})
        for p, x in got.items():
            np.testing.assert_array_equal(state[p], x, err_msg=p)
    # the reference's stacked state as numpy, straight into the port
    stacked = stacked_state_from_numpy(
        jax.tree.map(np.asarray, ref["engine"].state))
    _assert_trees(ref["engine"].state, stacked)


def test_stacked_eval_equals_loop_eval(ref_runs):
    """Ragged test sets (padding and the live mask): the stacked eval is
    bit-equal to the port's loop eval and to the reference's stacked eval,
    on a trained state."""
    ragged = [dataclasses.replace(c, test_x=c.test_x[: len(c.test_y) - k],
                                  test_y=c.test_y[: len(c.test_y) - k])
              for k, c in enumerate(_port_clients())]
    eng = ScaleEngine(make_strategy("dispfl"), _port_task(), ragged,
                      FLConfig(**CFG), reduction="ordered").restore(
                          ref_runs("dispfl-ordered")["mid"])
    loop = evaluate_clients(eng.task, eng.adapter.eval_params(eng.state),
                            ragged)
    assert evaluate_clients_stacked(eng.task, eng.state["params"],
                                    ragged) == loop
    assert eng._stacked_eval() == loop
    ref_clients = [dataclasses.replace(c, test_x=c.test_x[: len(c.test_y) - k],
                                       test_y=c.test_y[: len(c.test_y) - k])
                   for k, c in enumerate(ref_build(0, **DATA)[0])]
    ref_params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                              eng.state["params"])
    assert ref_eval_stacked(ref_make_task("smallcnn", 10, 8, width=4),
                            ref_params, ref_clients) == loop


def test_snapshot_messages_byte_identical(ref_runs):
    ref = ref_runs("dispfl-einsum")["engine"]
    port = _port_scale("dispfl", "einsum")
    port.state = stacked_state_from_numpy(jax.tree.map(np.asarray, ref.state))
    want, got = ref.snapshot_messages(), port.snapshot_messages()
    assert len(want) == len(got) == CFG["n_clients"]
    for a, b in zip(want, got):
        _assert_payloads(a["packed"], b["packed"])


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


ARGV = ["simulate", "--rounds", "2", "--clients", "4", "--local-epochs", "1",
        "--samples-per-class", "8", "--hw", "8", "--width", "4",
        "--degree", "2", "--partition", "pathological"]


