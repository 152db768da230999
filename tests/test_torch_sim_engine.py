"""The port's sync and async ``SimEngine`` and the engine's vmap local phase
against the reference, on the CPU, each from one reference archive
(``ref_runs``: each reference run computed once): trajectories, transfers
and ``LinkStats``, archives resumed across the packages, checkpoint
resume, refusals, the generic mix, vmap against the loop and the
reference's vmap.

World of the reference's own ``tests/test_sim.py``: K=4, smallcnn width 4,
hw 8, pathological 2 classes per client, 24 train per class, 3 rounds, 2
local epochs, batch 16, degree 2.  Initial params and masks come from
``jax.random``, which torch cannot replay, so the port starts from one
reference archive written by the reference ``SimEngine.save`` before round
0 (async engines take its state through the base engine's restore; an
async archive only exists once the event loop has run).

Tolerances:
- exact: events, links, loss draws, uplink schedules, availability,
  out-neighbours, packed archives (bitmaps and values bit for bit), masks,
  comm rows, FLOPs, accuracies, the transfer list, ``LinkStats``, the
  virtual clock and the async invariants;
- the port's sync ``SimEngine`` against the port's ``RoundEngine``: every
  leaf bit-equal;
- parameters against the reference within 1e-5 (measured after 3 rounds:
  3.0e-8 sync, 8.9e-8 async, 3.0e-8 for the vmap phase against the
  reference's vmap; fp32 rounding of the convolutions);
- port vmap against port loop: bit for bit (accuracies, masks and
  parameters), what the CPU measures.  ``chip_smoke.py`` holds the card to
  1e-3 at ResNet18-GN width, where two right fp32 answers already differ by
  about 4e-4 after one local epoch (the loop phase on the card against the
  same phase on the CPU, H100).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import build_federated_image_task as ref_build
from repro.fl import Checkpointer as RefCheckpointer
from repro.fl import FLConfig as RefFLConfig
from repro.fl import RoundEngine as RefRoundEngine
from repro.fl import make_cnn_task as ref_make_task
from repro.fl import make_strategy as ref_make_strategy
from repro.sim import SimEngine as RefSimEngine
from repro.sim import events as ref_events
from repro.sim import links as ref_links
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.checkpoint.npz import load_pytree, save_pytree
from repro_torch.checkpoint.packed import decode_packed, encode_packed
from repro_torch.core import accounting, topology
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import (
    Checkpointer,
    RoundEngine,
    StrategyBase,
    make_strategy,
)
from repro_torch.sim import (
    BernoulliAvailability,
    LossModel,
    SimEngine,
    hetero_speeds,
    measure_payload,
)
from repro_torch.sparse import codec
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.packed import pack_tree
from repro_torch.utils.tree import tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-5
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=2, batch_size=16, degree=2,
           eval_every=1)
ASYNC_KW = dict(mode="async", staleness=2, round_s=1.0, uplink="fifo")


def _async_kw(seed=0):
    return dict(ASYNC_KW, compute_speeds=hetero_speeds(4, seed=2),
                loss=LossModel(0.25, timeout_s=0.3, seed=seed))


def _ref_async_kw():
    return dict(ASYNC_KW, compute_speeds=ref_events.hetero_speeds(4, seed=2),
                loss=ref_links.LossModel(0.25, timeout_s=0.3, seed=0))


def _ref_np(tree):
    return {p: np.asarray(x) for p, x in ref_leaves(tree)}


def _port_np(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_leaves_with_path(tree)}


def _assert_state(ref_state, port_state, atol=PARAM_ATOL, what=""):
    """Masks exact, parameters within ``atol``; returns the largest
    parameter difference."""
    a, b = _ref_np(ref_state), _port_np(port_state)
    assert list(a) == list(b), what
    err = 0.0
    for k in a:
        if k.startswith("masks"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=f"{what} {k}")
            err = max(err, float(np.abs(a[k] - b[k]).max()))
    return err


def _assert_bit_equal(a_state, b_state):
    a, b = _port_np(a_state), _port_np(b_state)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _transfers(stats):
    return [dataclasses.astuple(t) for t in stats.transfers]


def _assert_stats(ref_stats, port_stats):
    assert _transfers(ref_stats) == _transfers(port_stats)
    for name in ("up", "down", "up_wire", "down_wire", "retrans_up",
                 "retrans_up_wire", "edge_bytes", "edge_busy_s"):
        np.testing.assert_array_equal(getattr(ref_stats, name),
                                      getattr(port_stats, name), err_msg=name)
    assert ref_stats.n_retransmits == port_stats.n_retransmits
    assert ref_stats.n_lost == port_stats.n_lost


def _metrics(m):
    d = m.to_dict()
    d.pop("wall_s")
    return d


def _port_task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _port_clients():
    return build_federated_image_task(0, **DATA)[0]


def _port_sim(name="dispfl", cfg=None, **kw):
    kw.setdefault("local_exec", "loop")
    return SimEngine(make_strategy(name), _port_task(), _port_clients(),
                     cfg or FLConfig(**CFG), **kw)


def _take_state(engine, path):
    """Start ``engine`` (any mode) from the round-0 state of an engine
    archive: the base engine's restore, which reads only the state."""
    RoundEngine._restore_payload(engine, load_pytree(path))
    return engine


class _SaveAt(Checkpointer):
    """Save once, after round ``at`` (0-based)."""

    def __init__(self, path, at):
        super().__init__(path)
        self.at = at

    def on_round_end(self, engine, metrics):
        if metrics.round == self.at:
            engine.save(self.path)

    def on_run_end(self, engine):
        pass


class _RefSaveAt(RefCheckpointer):
    def __init__(self, path, at):
        super().__init__(path)
        self.at = at

    def on_round_end(self, engine, metrics):
        if metrics.round == self.at:
            engine.save(self.path)

    def on_run_end(self, engine):
        pass


# ---------------------------------------------------------------------------
# reference runs, each built once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_sim")
    clients = ref_build(0, **DATA)[0]
    task = ref_make_task("smallcnn", 10, 8, width=4)
    cfg = RefFLConfig(**CFG)
    cache = {}

    def archive(name):
        key = ("archive", name)
        if key not in cache:
            path = str(d / f"{name}-r0.npz")
            RefSimEngine(ref_make_strategy(name), task, clients, cfg,
                         mode="sync").save(path)
            cache[key] = path
        return cache[key]

    def run(key):
        if key in cache:
            return cache[key]
        name, mode = key
        mid = str(d / f"{name}-{mode}-mid.npz")
        kw = (dict(_ref_async_kw(), local_exec="loop") if mode == "async"
              else dict(mode="sync", local_exec="loop"))
        eng = RefSimEngine(ref_make_strategy(name), task, clients, cfg,
                           callbacks=[_RefSaveAt(mid, 1)], **kw)
        metrics = [_metrics(m) for m in eng.rounds()]
        cache[key] = dict(engine=eng, metrics=metrics, mid=mid,
                          result=eng.result())
        return cache[key]

    def vmap():
        if "vmap" not in cache:
            eng = RefRoundEngine(ref_make_strategy("dispfl"), task, clients,
                                 cfg, local_exec="vmap")
            eng.run()
            cache["vmap"] = eng
        return cache["vmap"]

    return dict(archive=archive, run=run, vmap=vmap, task=task,
                clients=clients, cfg=cfg)


# ---------------------------------------------------------------------------
# substrate: topology, events, links, loss, uplinks, availability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dispfl", "dispfl_anneal"])
def test_sync_sim_matches_reference(ref_runs, name):
    ref = ref_runs["run"]((name, "sync"))
    port = _port_sim(name, mode="sync").restore(ref_runs["archive"](name))
    got = [_metrics(m) for m in port.rounds()]
    assert got == ref["metrics"]          # comm rows, FLOPs, acc, timeline
    _assert_stats(ref["engine"].stats, port.stats)
    assert port.clock.now == ref["engine"].clock.now
    assert port.acc_trace == ref["engine"].acc_trace
    _assert_state(ref["engine"].state, port.state)
    assert (port.report((0.0,)).to_dict()
            == ref["engine"].report((0.0,)).to_dict())


@pytest.mark.parametrize("name", ["dispfl", "dispfl_anneal"])
def test_sync_sim_bit_equal_to_port_round_engine(ref_runs, name):
    path = ref_runs["archive"](name)
    sim = _port_sim(name, mode="sync").restore(path)
    eng = RoundEngine(make_strategy(name), _port_task(), _port_clients(),
                      FLConfig(**CFG), local_exec="loop").restore(path)
    for a, b in zip(sim.rounds(), eng.rounds()):
        da, db = _metrics(a), _metrics(b)
        assert {k: da[k] for k in db} == db
    assert sim._comm == eng._comm and sim._flops == eng._flops
    _assert_bit_equal(sim.state, eng.state)
    assert sim.sim_time > 0 and len(sim.stats.transfers) > 0
    # every transfer carries the codec frame of what its sender held at the
    # round's start: replay the rounds and size the payloads
    replay = RoundEngine(make_strategy(name), _port_task(), _port_clients(),
                         FLConfig(**CFG), local_exec="loop").restore(path)
    sizes = []
    for t in range(CFG["rounds"]):
        ctx = replay._make_ctx(t)
        wire = [measure_payload(replay.strategy.snapshot_message(
            replay.state, k))[1] for k in range(4)]
        sizes += [wire[j] for j in range(4) for i in range(4)
                  if ctx.adjacency[i, j] > 0 and i != j]
        replay._run_one_round(t)
    assert sorted(sizes) == sorted(t.bytes_wire for t in sim.stats.transfers)
    assert sim.stats.up_wire.sum() == sum(sizes)


def test_sync_availability_matches_drop_prob(ref_runs):
    path = ref_runs["archive"]("dispfl")
    sim = _port_sim(mode="sync",
                    availability=BernoulliAvailability(4, 0.4, seed=0))
    sim.restore(path)
    eng = RoundEngine(make_strategy("dispfl"), _port_task(), _port_clients(),
                      FLConfig(**dict(CFG, drop_prob=0.4)),
                      local_exec="loop").restore(path)
    res_sim, res_eng = sim.run(), eng.run()
    assert res_sim.acc_history == res_eng.acc_history
    _assert_bit_equal(sim.state, eng.state)


# ---------------------------------------------------------------------------
# async mode
# ---------------------------------------------------------------------------


def _assert_async_matches(ref_eng, port):
    _assert_stats(ref_eng.stats, port.stats)
    assert port.clock.now == ref_eng.clock.now
    assert [t for t, _ in port.acc_trace] == [t for t, _ in ref_eng.acc_trace]
    assert port.acc_trace == ref_eng.acc_trace
    assert (port.observed_spread, port.observed_mix_lag,
            port.mixed_messages) == (ref_eng.observed_spread,
                                     ref_eng.observed_mix_lag,
                                     ref_eng.mixed_messages)
    assert port._comm == ref_eng._comm and port._flops == ref_eng._flops
    np.testing.assert_array_equal(port.uplink.free_at, ref_eng.uplink.free_at)
    return _assert_state(ref_eng.state, port.state)


def test_async_sim_matches_reference(ref_runs):
    """Loss with retransmits, a FIFO uplink and heterogeneous compute."""
    ref = ref_runs["run"](("dispfl", "async"))
    port = _take_state(_port_sim(**_async_kw()), ref_runs["archive"]("dispfl"))
    sparse_ops.reset_counters()
    got = [_metrics(m) for m in port.rounds()]
    assert got == ref["metrics"]
    _assert_async_matches(ref["engine"], port)
    eng = ref["engine"]
    assert eng.stats.n_retransmits > 0 and eng.mixed_messages > 0
    assert port.observed_spread <= 2 and port.observed_mix_lag <= 2
    # one fold per arrived payload leaf (the packed mix_one)
    n_leaves = len(tree_leaves_with_path(port.state["params"][0]))
    assert sparse_ops.COUNTERS["accum_calls"] == port.mixed_messages * n_leaves
    assert (port.report((0.0,)).to_dict()
            == eng.report((0.0,)).to_dict())


def test_async_archive_resumes_from_reference_in_port(ref_runs):
    ref = ref_runs["run"](("dispfl", "async"))
    port = _port_sim(**_async_kw()).restore(ref["mid"])
    assert port._next_round == 2
    got = [_metrics(m) for m in port.rounds()]
    assert got == ref["metrics"][2:]
    _assert_async_matches(ref["engine"], port)


def test_async_archive_resumes_from_port_in_reference(ref_runs, tmp_path):
    mid = str(tmp_path / "port-mid.npz")
    port = _take_state(_port_sim(**_async_kw(), callbacks=[_SaveAt(mid, 1)]),
                       ref_runs["archive"]("dispfl"))
    for _ in port.rounds():
        pass
    ref = RefSimEngine(ref_make_strategy("dispfl"), ref_runs["task"],
                       ref_runs["clients"], ref_runs["cfg"],
                       local_exec="loop", **_ref_async_kw()).restore(mid)
    assert ref._next_round == 2
    for _ in ref.rounds():
        pass
    _assert_async_matches(ref, port)
    _assert_stats(ref_runs["run"](("dispfl", "async"))["engine"].stats,
                  ref.stats)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_checkpoint_resume_bit_identical(ref_runs, mode, tmp_path):
    kw = _async_kw() if mode == "async" else dict(mode="sync")
    start = ref_runs["archive"]("dispfl")

    def build(**extra):
        eng = _port_sim(**kw, **extra)
        return _take_state(eng, start) if mode == "async" else eng.restore(
            start)

    full = build()
    want = [_metrics(m) for m in full.rounds()]
    path = str(tmp_path / "ck.npz")
    first = build()
    got = []
    for m in first.rounds():
        got.append(_metrics(m))
        if m.round == 1:
            first.save(path)
            break
    resumed = _port_sim(**kw).restore(path)
    got += [_metrics(m) for m in resumed.rounds()]
    assert got == want
    _assert_bit_equal(resumed.state, full.state)
    assert resumed.clock.now == full.clock.now
    assert resumed.acc_trace == full.acc_trace
    assert _transfers(resumed.stats) == _transfers(full.stats)
    assert resumed.report((0.0,)).to_dict() == full.report((0.0,)).to_dict()


def test_sim_refusals(ref_runs, tmp_path):
    path = str(tmp_path / "eng.npz")
    RoundEngine(make_strategy("dispfl"), _port_task(), _port_clients(),
                FLConfig(**CFG)).save(path)
    with pytest.raises(ValueError, match="SimEngine checkpoint"):
        _port_sim(mode="sync").restore(path)
    with pytest.raises(ValueError, match="mode"):
        _port_sim(**_async_kw()).restore(ref_runs["archive"]("dispfl"))
    with pytest.raises(ValueError, match="mode must be"):
        _port_sim(mode="gossip")

    class Server(StrategyBase):
        def init_state(self, task, clients, cfg):
            super().init_state(task, clients, cfg)
            return {"params": []}

        def round_flops(self, state, ctx):
            return accounting.FlopsReport(1.0, 1.0, 1.0)

    sim = SimEngine(Server(), _port_task(), _port_clients(), FLConfig(**CFG),
                    mode="async")
    with pytest.raises(ValueError, match="decentralized"):
        list(sim.rounds())


def test_generic_mix_one_equals_packed_override(ref_runs):
    """``StrategyBase.mix_one`` (install the payloads, run the full mix,
    keep k) gives DisPFL's packed O(degree) fold bit for bit."""
    eng = RoundEngine(make_strategy("dispfl"), _port_task(), _port_clients(),
                      FLConfig(**CFG), local_exec="loop")
    eng.restore(ref_runs["archive"]("dispfl"))
    eng._run_one_round(0)            # trained, evolved masks
    strat, state = eng.strategy, eng.state
    senders = {j: strat.snapshot_message(state, j) for j in (0, 2, 3)}
    ctx = eng._make_ctx(1)
    a = np.eye(4)
    a[1, list(senders)] = 1.0
    ctx = dataclasses.replace(ctx, adjacency=a)
    fast = {k: list(v) for k, v in state.items()}
    slow = {k: list(v) for k, v in state.items()}
    strat.mix_one(fast, 1, senders, ctx)
    StrategyBase.mix_one(strat, slow, 1, senders, ctx)
    for k in range(4):
        _assert_bit_equal(fast["params"][k], slow["params"][k])
        _assert_bit_equal(fast["masks"][k], slow["masks"][k])
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_leaves_with_path(fast["params"][1]),
        tree_leaves_with_path(state["params"][1])))
    before = {k: list(v) for k, v in state.items()}
    strat.mix_one(state, 1, {}, ctx)
    StrategyBase.mix_one(strat, state, 1, {}, ctx)
    assert all(x is y for x, y in zip(before["params"], state["params"]))


# ---------------------------------------------------------------------------
# the vmap local phase
# ---------------------------------------------------------------------------


def _vmap_pair(clients, cfg, name="dispfl", start=None):
    """The same run with ``local_exec`` loop and vmap, from ``start`` (an
    archive) or from the seed's own init."""
    runs = {}
    for mode in ("loop", "vmap"):
        eng = RoundEngine(make_strategy(name), _port_task(), clients, cfg,
                          local_exec=mode)
        if start is not None:
            eng.restore(start)
        runs[mode] = (eng, eng.run())
    return runs


def _assert_vmap_loop(runs):
    (loop, res_l), (vmap, res_v) = runs["loop"], runs["vmap"]
    assert res_v.final_accs == res_l.final_accs
    assert res_v.acc_history == res_l.acc_history
    _assert_bit_equal(vmap.state, loop.state)


def test_vmap_matches_loop(ref_runs):
    runs = _vmap_pair(_port_clients(), FLConfig(**CFG),
                      start=ref_runs["archive"]("dispfl"))
    _assert_vmap_loop(runs)


def test_vmap_matches_reference_vmap(ref_runs):
    ref = ref_runs["vmap"]()
    port = RoundEngine(make_strategy("dispfl"), _port_task(), _port_clients(),
                       FLConfig(**CFG), local_exec="vmap")
    port.restore(ref_runs["archive"]("dispfl")).run()
    assert port._acc_history == ref._acc_history
    assert port._comm == ref._comm
    _assert_state(ref.state, port.state)


CLI = ["simulate", "--clients", "4", "--local-epochs", "1",
       "--samples-per-class", "8", "--hw", "8", "--width", "4",
       "--degree", "2", "--partition", "pathological", "--exec", "loop",
       "--sim"]
CLI_ASYNC = ["--async", "--staleness", "1", "--compute-hetero",
             "--bandwidth-skew", "10", "--loss-prob", "0.2",
             "--uplink-mode", "fifo", "--target", "0.1"]


def test_port_sim_archive_loads_in_reference_round_engine(ref_runs, tmp_path):
    """The superset direction: the reference's RoundEngine reads a port
    sync SimEngine archive's state and histories."""
    sim = _port_sim(mode="sync").restore(ref_runs["archive"]("dispfl"))
    sim.run()
    path = str(tmp_path / "sim.npz")
    sim.save(path)
    ref = RefRoundEngine(ref_make_strategy("dispfl"), ref_runs["task"],
                         ref_runs["clients"], ref_runs["cfg"]).restore(path)
    assert ref._acc_history == sim._acc_history
    assert ref._comm == sim._comm
    state = _ref_np(ref.state)
    for p, x in _port_np(sim.state).items():
        assert state[p].tobytes() == x.tobytes(), p
