"""The port's strategy zoo through the network simulator and the stacked
engine, against the reference on the CPU.  The vmap local phase and the
CLI are ``test_torch_strategies_vmap.py``'s.

World of the reference's ``tests/test_sim.py``: K=4, smallcnn width 4, hw
8, pathological 2 classes per client, 24 train per class, 3 rounds, 2 local
epochs, batch 16, degree 2.  Every port run starts from one reference
archive (initial params come from ``jax.random``); async engines take its
state through the base engine's restore.

Tolerances:
- exact: comm rows, FLOPs, accuracies, the transfer list, ``LinkStats``,
  the virtual clock, the bytes on the wire and the refusal messages;
- parameters against the reference within ``PARAM_ATOL`` = 1e-5 (the
  reference's own ``tests/test_scale_engine.py`` bound for stacked dpsgd);
- the vmap local phase against the port's loop: bit for bit (the CPU
  measures no gap; the card's bound is ``chip_smoke.py``'s).
"""
import dataclasses

import numpy as np
import pytest

from repro.checkpoint import load_pytree as ref_load_pytree
from repro.data import build_federated_image_task as ref_build
from repro.fl import FLConfig as RefFLConfig
from repro.fl import RoundEngine as RefRoundEngine
from repro.fl import make_cnn_task as ref_make_task
from repro.fl import make_strategy as ref_make_strategy
from repro.scale import ScaleEngine as RefScaleEngine
from repro.scale import make_stacked as ref_make_stacked
from repro.sim import SimEngine as RefSimEngine
from repro.sim import events as ref_events
from repro.sim import links as ref_links
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.checkpoint.npz import load_pytree, tree_from_numpy
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import RoundEngine, make_strategy, strategy_names
from repro_torch.scale import ScaleEngine
from repro_torch.scale.strategy import make_stacked
from repro_torch.sim import LossModel, SimEngine, hetero_speeds
from repro_torch.utils.tree import tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-5
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=2, batch_size=16, degree=2,
           eval_every=1)
ASYNC_KW = dict(mode="async", staleness=2, round_s=1.0, uplink="fifo")


def _async_kw():
    return dict(ASYNC_KW, compute_speeds=hetero_speeds(4, seed=2),
                loss=LossModel(0.25, timeout_s=0.3, seed=0))


def _ref_async_kw():
    return dict(ASYNC_KW, compute_speeds=ref_events.hetero_speeds(4, seed=2),
                loss=ref_links.LossModel(0.25, timeout_s=0.3, seed=0))


def _ref_np(tree):
    return {p: np.asarray(x) for p, x in ref_leaves(tree)}


def _port_np(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_leaves_with_path(tree)}


def _assert_state(ref_state, port_state, atol=PARAM_ATOL):
    a, b = _ref_np(ref_state), _port_np(port_state)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def _assert_bit_equal(a_state, b_state):
    a, b = _port_np(a_state), _port_np(b_state)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _metrics(m):
    d = m.to_dict()
    d.pop("wall_s")
    return d


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


def _port_task():
    return make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")


def _port_clients():
    return build_federated_image_task(0, **DATA)[0]


@pytest.fixture(scope="module")
def world():
    return dict(task=ref_make_task("smallcnn", 10, 8, width=4),
                clients=ref_build(0, **DATA)[0])


def _ref_sim(world, name, cfg=None, strategy_kw=None, **kw):
    kw.setdefault("local_exec", "loop")
    return RefSimEngine(ref_make_strategy(name, **(strategy_kw or {})),
                        world["task"], world["clients"],
                        cfg or RefFLConfig(**CFG), **kw)


def _port_sim(name, cfg=None, strategy_kw=None, **kw):
    kw.setdefault("local_exec", "loop")
    return SimEngine(make_strategy(name, **(strategy_kw or {})), _port_task(),
                     _port_clients(), cfg or FLConfig(**CFG), **kw)


def _share_mask(ref, port):
    """The reference strategy's static shared mask (not in the archive)."""
    port.strategy.mask = tree_from_numpy(ref.strategy.mask)
    port.strategy.densities = dict(ref.strategy.densities)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


def test_sync_sim_dpsgd_matches_reference(world, tmp_path):
    ref = _ref_sim(world, "dpsgd", mode="sync")
    path = str(tmp_path / "r0.npz")
    ref.save(path)
    want = [_metrics(m) for m in ref.rounds()]
    port = _port_sim("dpsgd", mode="sync").restore(path)
    assert [_metrics(m) for m in port.rounds()] == want
    _assert_stats(ref.stats, port.stats)
    assert port.clock.now == ref.clock.now
    _assert_state(ref.state, port.state)
    eng = RoundEngine(make_strategy("dpsgd"), _port_task(), _port_clients(),
                      FLConfig(**CFG), local_exec="loop").restore(path)
    eng.run()
    _assert_bit_equal(port.state, eng.state)
    assert port._comm == eng._comm and len(port.stats.transfers) > 0


@pytest.mark.parametrize("topology", ["ring", "fc"])
def test_sync_sim_dpsgd_param_fraction_bytes(world, topology, tmp_path):
    """dpsgd on a half-density shared mask: measured bytes equal the
    reference's and the accounting (static topology and nnz: the busiest
    node's total is the per-round busiest summed)."""
    cfg = dict(CFG, topology=topology, rounds=2, local_epochs=1)
    ref = _ref_sim(world, "dpsgd", RefFLConfig(**cfg),
                   dict(param_fraction=0.5), mode="sync")
    path = str(tmp_path / "r0.npz")
    ref.save(path)
    ref.run()
    port = _port_sim("dpsgd", FLConfig(**cfg), dict(param_fraction=0.5),
                     mode="sync").restore(path)
    _share_mask(ref, port)
    port.run()
    _assert_stats(ref.stats, port.stats)
    assert port._comm == ref._comm
    assert port.stats.total_mb == pytest.approx(sum(port._comm["total_mb"]))
    assert max(port.stats.per_node_mb()) == pytest.approx(
        sum(port._comm["busiest_mb"]))
    _assert_state(ref.state, port.state)


@pytest.mark.parametrize("name", ["dfedalt", "dfedsam", "dpsgd"])
def test_async_sim_matches_reference(world, name, tmp_path):
    """Loss with retransmits, a FIFO uplink and heterogeneous compute:
    transfers and ``LinkStats`` exact — dfedalt's payloads carry the body
    only, dfedsam's and dpsgd's the dense model."""
    path = str(tmp_path / "r0.npz")
    _ref_sim(world, name, mode="sync").save(path)
    ref = _ref_sim(world, name, **_ref_async_kw())
    RefRoundEngine._restore_payload(ref, ref_load_pytree(path, as_jnp=False))
    want = [_metrics(m) for m in ref.rounds()]
    port = _port_sim(name, **_async_kw())
    RoundEngine._restore_payload(port, load_pytree(path))
    assert [_metrics(m) for m in port.rounds()] == want
    _assert_stats(ref.stats, port.stats)
    assert port.clock.now == ref.clock.now
    assert port.mixed_messages == ref.mixed_messages > 0
    assert port.stats.n_retransmits > 0
    _assert_state(ref.state, port.state)
    if name == "dfedalt":
        body = port.strategy.body_nnz
        assert body < port.strategy.n_coords
        assert {t.bytes_values for t in port.stats.transfers} == {4.0 * body}


def test_async_refuses_centralized_strategies_as_the_reference(world):
    with pytest.raises(ValueError) as ref_err:
        list(_ref_sim(world, "fedavg", mode="async").rounds())
    with pytest.raises(ValueError) as port_err:
        list(_port_sim("fedavg", mode="async").rounds())
    assert str(port_err.value) == str(ref_err.value)
    assert "decentralized" in str(port_err.value)


def test_sync_sim_centralized_is_compute_only(world, tmp_path):
    path = str(tmp_path / "r0.npz")
    ref = _ref_sim(world, "subfedavg", mode="sync")
    ref.save(path)
    want = [_metrics(m) for m in ref.rounds()]
    port = _port_sim("subfedavg", mode="sync").restore(path)
    assert [_metrics(m) for m in port.rounds()] == want
    assert len(port.stats.transfers) == 0 and port.clock.now > 0
    _assert_state(ref.state, port.state)


# ---------------------------------------------------------------------------
# the stacked engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["einsum", "ordered"])
def test_scale_dpsgd_matches_reference(world, reduction, tmp_path):
    ref = RefScaleEngine(ref_make_strategy("dpsgd"), world["task"],
                         world["clients"], RefFLConfig(**CFG),
                         reduction=reduction)
    path = str(tmp_path / "r0.npz")
    ref.save(path)
    want = [_metrics(m) for m in ref.rounds()]
    port = ScaleEngine(make_strategy("dpsgd"), _port_task(), _port_clients(),
                       FLConfig(**CFG), reduction=reduction).restore(path)
    assert [_metrics(m) for m in port.rounds()] == want
    for p, x in _ref_np(ref.state).items():
        np.testing.assert_allclose(x, _port_np(port.state)[p], rtol=0,
                                   atol=PARAM_ATOL, err_msg=p)
    assert port.phase_s[0].keys() == {"inputs", "mix", "local", "evolve",
                                      "eval"}


@pytest.mark.parametrize("name,kw", [("dpsgd_ft", {}),
                                     ("dpsgd", {"param_fraction": 0.5})])
def test_scale_dpsgd_refusals_match_reference(world, name, kw):
    with pytest.raises(ValueError) as ref_err:
        ref_make_stacked(ref_make_strategy(name, **kw)).validate(
            RefFLConfig(**CFG))
    with pytest.raises(ValueError) as port_err:
        ScaleEngine(make_strategy(name, **kw), _port_task(), _port_clients(),
                    FLConfig(**CFG))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(KeyError, match="no stacked adapter"):
        make_stacked(make_strategy("fedavg"))


# ---------------------------------------------------------------------------
# the vmap local phase
# ---------------------------------------------------------------------------


CLI = ["simulate", "--clients", "4", "--local-epochs", "1",
       "--samples-per-class", "8", "--hw", "8", "--width", "4",
       "--degree", "2", "--partition", "pathological", "--exec", "loop"]


