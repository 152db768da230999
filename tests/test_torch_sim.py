"""The port's network simulator substrate (``repro_torch.sim``: topology,
events, links, loss, uplinks, availability, measured comm, packed
archives), the vmap local phase on ragged schedules, ``--exec auto`` and
the ``--sim`` CLI against the reference, on the CPU.  The engines' runs
from one reference archive are ``test_torch_sim_engine.py``'s.

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
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import decode_packed as ref_decode_packed
from repro.checkpoint import encode_packed as ref_encode_packed
from repro.checkpoint import load_pytree as ref_load_pytree
from repro.checkpoint import save_pytree as ref_save_pytree
from repro.core import accounting as ref_accounting
from repro.core import topology as ref_topology
from repro.launch import train as ref_train
from repro.sim import availability as ref_avail
from repro.sim import events as ref_events
from repro.sim import links as ref_links
from repro.sparse import pack_tree as ref_pack_tree
from repro_torch.checkpoint.npz import load_pytree, save_pytree
from repro_torch.checkpoint.packed import decode_packed, encode_packed
from repro_torch.core import accounting, topology
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import Checkpointer, RoundEngine, make_strategy
from repro_torch.launch import train as port_train
from repro_torch.sim import (
    BandwidthTrace,
    BernoulliAvailability,
    ComputeModel,
    EventQueue,
    LinkModel,
    LossModel,
    SimEngine,
    TraceAvailability,
    UplinkScheduler,
    VirtualClock,
    dropping_trace,
    hetero_speeds,
    measure_payload,
)
from repro_torch.sim import events as port_events
from repro_torch.sparse import codec
from repro_torch.sparse.packed import pack_tree, words_to_numpy
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-5
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=2, batch_size=16, degree=2,
           eval_every=1)
ASYNC_KW = dict(mode="async", staleness=2, round_s=1.0, uplink="fifo")


def _port_np(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_leaves_with_path(tree)}


def _assert_bit_equal(a_state, b_state):
    a, b = _port_np(a_state), _port_np(b_state)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _port_task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _port_clients():
    return build_federated_image_task(0, **DATA)[0]


@pytest.mark.parametrize("n,k,t,degree,seed", [
    (10, 3, 5, 4, 1), (4, 0, 0, 2, 0), (4, 2, 7, 3, 0), (16, 15, 2, 10, 9)])
def test_directed_out_neighbors_match_reference(n, k, t, degree, seed):
    got = topology.directed_out_neighbors(n, k, t, degree, seed)
    want = ref_topology.directed_out_neighbors(n, k, t, degree, seed)
    np.testing.assert_array_equal(got, want)
    assert topology.GOSSIP_STREAM == ref_topology.GOSSIP_STREAM
    a = topology.make_adjacency("random", n, t, min(degree, n - 1), seed)
    assert topology.busiest_node_degree(a) == ref_topology.busiest_node_degree(a)
    np.testing.assert_array_equal(topology.mixing_matrix(a),
                                  ref_topology.mixing_matrix(a))


def test_events_and_compute_match_reference():
    pushes = [(2.0, "wake", 0), (1.0, "wake", 1), (1.0, "arrival", 2),
              (0.5, "done", 3), (1.0, "done", 4)]
    got, want = EventQueue(), ref_events.EventQueue()
    for t, kind, k in pushes:
        got.push(t, kind, k=k)
        want.push(t, kind, k=k)
    assert ([(e.time, e.seq, e.kind, e.data) for e in got.pending()]
            == [(e.time, e.seq, e.kind, e.data) for e in want.pending()])
    restored = EventQueue()
    restored.restore(got.pending()[1:])
    restored.push(1.0, "wake", k=9)          # after every restored seq
    order = [(e.time, e.data["k"]) for e in restored.drain()]
    assert order == [(1.0, 1), (1.0, 2), (1.0, 4), (1.0, 9), (2.0, 0)]
    clock = VirtualClock()
    clock.advance_to(3.0)
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(2.0)
    for seed in (0, 3):
        np.testing.assert_array_equal(hetero_speeds(10, seed=seed),
                                      ref_events.hetero_speeds(10, seed=seed))
    cms = (ComputeModel.paced(5, 1e9, 2.0, speeds=hetero_speeds(5)),
           ref_events.ComputeModel.paced(5, 1e9, 2.0,
                                         speeds=ref_events.hetero_speeds(5)))
    for k in range(5):
        assert cms[0].local_time(k, 3e8) == cms[1].local_time(k, 3e8)
    assert cms[0].mean_round_s(7e8) == cms[1].mean_round_s(7e8)
    assert (ComputeModel.heterogeneous(6, seed=4).speeds.tolist()
            == ref_events.ComputeModel.heterogeneous(6, seed=4).speeds.tolist())
    assert port_events.WAKE == ref_events.WAKE


def test_links_and_bandwidth_trace_match_reference(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"times": [0.0, 2.0],
                             "scale": [[1.0, 0.5, 2.0, 1.0], [0.25] * 4]}))
    got = LinkModel.skewed(4, mbps=50, skew=10, latency_ms=5, seed=3,
                           trace=BandwidthTrace.from_json(str(p)))
    want = ref_links.LinkModel.skewed(
        4, mbps=50, skew=10, latency_ms=5, seed=3,
        trace=ref_links.BandwidthTrace.from_json(str(p)))
    np.testing.assert_array_equal(got.bw_mbps, want.bw_mbps)
    for src, dst, t in ((0, 1, 0.0), (1, 2, 1.5), (3, 0, 2.0), (2, 3, 9.0)):
        assert (got.transfer_time(123456.0, src, dst, t)
                == want.transfer_time(123456.0, src, dst, t))
    u = LinkModel.uniform(4, mbps=100, latency_ms=10)
    assert u.transfer_time(1e6, 0, 1) == ref_links.LinkModel.uniform(
        4, mbps=100, latency_ms=10).transfer_time(1e6, 0, 1)
    with pytest.raises(ValueError, match="positive"):
        BandwidthTrace([0.0], np.array([0.0]))


@pytest.mark.parametrize("mode", ["parallel", "fifo", "fair"])
def test_uplink_disciplines_match_reference(mode):
    lm = LinkModel.skewed(4, mbps=100, skew=4, seed=1)
    ref_lm = ref_links.LinkModel.skewed(4, mbps=100, skew=4, seed=1)
    got, want = UplinkScheduler(4, mode), ref_links.UplinkScheduler(4, mode)
    batches = [(0, [(1, 1e6), (2, 3e5), (3, 7e5)], 1.0),
               (0, [(2, 5e5)], 1.01), (2, [(0, 2e6), (1, 2e6)], 0.0),
               (0, [(3, 1e4)], 9.0)]
    for src, jobs, t in batches:
        assert got.schedule(lm, src, jobs, t) == want.schedule(
            ref_lm, src, jobs, t)
    np.testing.assert_array_equal(got.state_dict()["free_at"],
                                  want.state_dict()["free_at"])
    with pytest.raises(ValueError, match="uplink mode"):
        UplinkScheduler(4, "warp")


def test_loss_model_matches_reference():
    got = LossModel(0.5, timeout_s=0.2, max_retries=3, seed=1)
    want = ref_links.LossModel(0.5, timeout_s=0.2, max_retries=3, seed=1)
    draws = [(s, d, t) for s in range(3) for d in range(3) for t in range(20)]
    assert ([got.attempts(*x) for x in draws]
            == [want.attempts(*x) for x in draws])
    assert any(a > 1 for a, _ in (got.attempts(*x) for x in draws))
    assert LossModel(0.0).attempts(3, 2, 7) == (1, True)
    for bad in (dict(loss_prob=1.0), dict(loss_prob=0.1, timeout_s=0.0)):
        with pytest.raises(ValueError):
            LossModel(**bad)


def test_availability_matches_reference():
    av = BernoulliAvailability(12, 0.4, seed=7)
    ref = ref_avail.BernoulliAvailability(12, 0.4, seed=7)
    tr = dropping_trace(12, 5, 0.4, seed=7)
    for t in range(7):
        np.testing.assert_array_equal(av.alive(t), ref.alive(t))
        np.testing.assert_array_equal(tr.alive(t), ref.alive(t % 5))
        assert [av.up(k, t) for k in range(12)] == [ref.up(k, t)
                                                    for k in range(12)]
        np.testing.assert_array_equal(
            topology.make_adjacency("fc", 12, t, seed=7, alive=av.alive(t)),
            ref_topology.make_adjacency("fc", 12, t, seed=7, drop_prob=0.4))
    assert not av.always_up and TraceAvailability(np.ones((1, 3))).alive(4).all()
    with pytest.raises(ValueError, match="trace"):
        TraceAvailability(np.zeros((0, 3)))


def test_measured_comm_matches_reference():
    a = ref_topology.make_adjacency("random", 6, 2, 3, 0)
    vals = [1000.0, 2000.0, 0.0, 50.0, 7.0, 300.0]
    wire = [1100, 2100, 8, 60, 20, 400]
    got = accounting.measured_comm(a, vals, wire)
    want = ref_accounting.measured_comm(a, vals, wire)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# packed payloads: archives and bytes on the wire
# ---------------------------------------------------------------------------


def _payload_world(seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"w": (3, 3, 2, 4)}, "fc": {"w": (17, 10), "b": (10,)}}
    m = {k: {n: (rng.random(s) < 0.4).astype(np.float32)
             for n, s in v.items()} for k, v in shapes.items()}
    w = {k: {n: rng.normal(size=a.shape).astype(np.float32) * a
             for n, a in v.items()} for k, v in m.items()}
    return w, m


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaf_pairs(ref_tree, port_tree):
    ra = jax.tree.leaves(ref_tree, is_leaf=lambda t: hasattr(t, "bitmap"))
    pa_ = [p for _, p in tree_leaves_with_path(
        port_tree, is_leaf=lambda t: hasattr(t, "bitmap"))]
    assert len(ra) == len(pa_)
    return zip(ra, pa_)


@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_packed_archives_interchange_with_reference(dtype, tmp_path):
    """A payload tree encoded by either package decodes in the other, with
    bitmap and values verbatim, through the .npz archive."""
    w, m = _payload_world()
    ref_dtype = np.float16 if dtype == "fp16" else None
    port_dtype = torch.float16 if dtype == "fp16" else None
    ref_msg = {"packed": ref_pack_tree(jax.tree.map(jax.numpy.asarray, w),
                                       jax.tree.map(jax.numpy.asarray, m),
                                       dtype=ref_dtype)}
    port_msg = {"packed": pack_tree(_torch_tree(w), _torch_tree(m),
                                    dtype=port_dtype)}
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_save_pytree(a, ref_encode_packed(ref_msg))
    save_pytree(b, encode_packed(port_msg))
    from_ref = decode_packed(load_pytree(a))
    from_port = ref_decode_packed(ref_load_pytree(b, as_jnp=False))
    for x, y in _leaf_pairs(ref_msg, from_ref):
        np.testing.assert_array_equal(np.asarray(x.bitmap),
                                      words_to_numpy(y.bitmap))
        assert np.asarray(x.values).tobytes() == y.values.numpy().tobytes()
        assert tuple(x.shape) == y.shape
    for x, y in _leaf_pairs(from_port, port_msg):
        np.testing.assert_array_equal(np.asarray(x.bitmap),
                                      words_to_numpy(y.bitmap))
        assert np.asarray(x.values).tobytes() == y.values.numpy().tobytes()
    again = decode_packed(encode_packed(port_msg))
    for x, y in _leaf_pairs(from_port, again):
        assert np.asarray(x.values).tobytes() == y.values.numpy().tobytes()
    # sizes: value bytes by the values' own itemsize, wire bytes by the codec
    vb, wb = measure_payload(port_msg)
    assert (vb, wb) == ref_links.measure_payload(ref_msg)
    assert wb == codec.encoded_nbytes(port_msg["packed"])


def test_measure_payload_dense_fallback_matches_reference():
    w, m = _payload_world(5)
    got = measure_payload({"params": _torch_tree(w), "mask": _torch_tree(m)})
    want = ref_links.measure_payload({"params": w, "mask": m})
    assert got == want
    assert measure_payload({"params": _torch_tree(w), "mask": None}) == \
        ref_links.measure_payload({"params": w, "mask": None})


# ---------------------------------------------------------------------------
# sync mode
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


@pytest.mark.parametrize("name", ["dispfl", "dispfl_anneal"])
def test_vmap_ragged_schedules_and_momentum_match_loop(name):
    """Client 0 trimmed so step counts disagree (padded no-op steps), and
    momentum 0.9 (stacked optimizer state, zeroed each local phase)."""
    clients = _port_clients()
    c0 = clients[0]
    ragged = [dataclasses.replace(c0, train_x=c0.train_x[:-16],
                                  train_y=c0.train_y[:-16])] + clients[1:]
    assert len({-(-c.n_train // 16) for c in ragged}) > 1
    cfg = FLConfig(**dict(CFG, rounds=2, momentum=0.9))
    _assert_vmap_loop(_vmap_pair(ragged, cfg, name))


def test_auto_resolves_as_the_reference():
    clients, cfg = _port_clients(), FLConfig(**CFG)
    eng = RoundEngine(make_strategy("dispfl"), _port_task(), clients, cfg)
    ctx = eng._make_ctx(0)
    assert eng.local_exec == "auto" and eng._use_vmap(ctx, [0, 1, 2, 3])
    hetero = dataclasses.replace(cfg, capacities=[0.2, 0.4, 0.6, 0.8])
    eng = RoundEngine(make_strategy("dispfl"), _port_task(), clients, hetero)
    assert not eng._use_vmap(eng._make_ctx(0), [0, 1, 2, 3])
    res = eng.run()                      # auto -> loop, no raise
    assert len(res.final_accs) == 4
    forced = RoundEngine(make_strategy("dispfl"), _port_task(), clients,
                         hetero, local_exec="vmap")
    with pytest.raises(ValueError, match="heterogeneous capacities"):
        forced.run()
    short = [dataclasses.replace(clients[0], train_x=clients[0].train_x[:8],
                                 train_y=clients[0].train_y[:8])] + clients[1:]
    forced = RoundEngine(make_strategy("dispfl"), _port_task(), short, cfg,
                         local_exec="vmap")
    with pytest.raises(ValueError, match="effective batch size"):
        forced.run()
    assert not RoundEngine(make_strategy("dispfl"), _port_task(), short,
                           cfg)._use_vmap(ctx, [0, 1, 2, 3])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


CLI = ["simulate", "--clients", "4", "--local-epochs", "1",
       "--samples-per-class", "8", "--hw", "8", "--width", "4",
       "--degree", "2", "--partition", "pathological", "--exec", "loop",
       "--sim"]
CLI_ASYNC = ["--async", "--staleness", "1", "--compute-hetero",
             "--bandwidth-skew", "10", "--loss-prob", "0.2",
             "--uplink-mode", "fifo", "--target", "0.1"]


def _ref_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    capsys.readouterr()
    ref_train.main()
    out = capsys.readouterr().out
    return json.loads(out[out.index("{\n"):])


@pytest.mark.parametrize("extra", [[], CLI_ASYNC], ids=["sync", "async"])
def test_cli_sim_matches_reference(extra, monkeypatch, capsys, tmp_path):
    """Both CLIs resume one reference archive (written by the reference
    CLI after round 1; async resumes a finished run with more rounds) and
    print the same summary, ``"sim"`` row included."""
    ck = str(tmp_path / "ck.npz")
    _ref_cli(monkeypatch, capsys, CLI + extra + ["--rounds", "1",
                                                 "--sim-checkpoint", ck])
    argv = CLI + extra + ["--rounds", "2", "--resume", ck]
    want = _ref_cli(monkeypatch, capsys, argv)
    got = port_train.main(argv + ["--device", "cpu"])
    for d in (want, got):
        d.pop("wall_s")
    assert got.pop("device") == "cpu"
    got.pop("round_wall_s"), got.pop("phase_s")
    assert got == want
    assert got["sim"]["mode"] == ("async" if extra else "sync")


@pytest.mark.parametrize("extra", [
    ["--sim", "--scale"], ["--async"], ["--staleness", "1", "--loss-prob",
                                        "0.1"],
    ["--uplink-mode", "fifo", "--sim-checkpoint", "x.npz"],
    ["--sim", "--bandwidth-skew", "0.5"], ["--scale-reduction", "ordered"]])
def test_cli_flag_errors_match_reference(extra, monkeypatch, capsys):
    argv = ["simulate", "--rounds", "1"] + extra
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        ref_train.main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as port_exit:
        port_train.main(argv + ["--device", "cpu"])
    port_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert ref_exit.value.code == port_exit.value.code == 2
    assert (port_err.split("error: ", 1)[1]
            == ref_err.split("error: ", 1)[1])


def test_cli_sim_refuses_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--async"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_train.main(CLI + extra + ["--rounds", "1"])


