"""The port's strategy zoo through the vmap local phase (against the port's
loop) and the CLI (against the reference's), on the CPU.

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
import copy
import json
import sys

import numpy as np
import pytest
import torch

from repro.fl.engine import strategy_names as ref_strategy_names
from repro.launch import train as ref_train
from repro_torch.checkpoint.npz import load_pytree
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import RoundEngine, make_strategy, strategy_names
from repro_torch.launch import train as port_train
from repro_torch.scale import ScaleEngine
from repro_torch.scale.strategy import make_stacked
from repro_torch.sim import SimEngine
from repro_torch.utils.tree import tree_leaves_with_path
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


@pytest.mark.parametrize("name", ["dpsgd", "local", "fedavg", "fomo",
                                  "subfedavg"])
def test_vmap_equals_loop(name):
    """The unmasked (dpsgd, local, fedavg, fomo) and masked (subfedavg)
    stacked phases give the loop's bits; FedAvg's selected clients all
    start from the one global model."""
    runs = {}
    start = RoundEngine(make_strategy(name), _port_task(), _port_clients(),
                        FLConfig(**CFG)).state
    for mode in ("loop", "vmap"):
        eng = RoundEngine(make_strategy(name), _port_task(), _port_clients(),
                          FLConfig(**CFG), local_exec=mode)
        eng.state = copy.deepcopy(start)
        runs[mode] = (eng, eng.run())
    (loop, res_l), (vmap, res_v) = runs["loop"], runs["vmap"]
    assert vmap.state is not loop.state
    assert res_v.acc_history == res_l.acc_history
    assert res_v.final_accs == res_l.final_accs
    _assert_bit_equal(vmap.state, loop.state)


def test_vmap_refuses_what_the_loop_keeps():
    for name in ("ditto", "dfedalt", "dfedsam"):
        eng = RoundEngine(make_strategy(name), _port_task(), _port_clients(),
                          FLConfig(**CFG), local_exec="vmap")
        with pytest.raises(ValueError, match="not vmap-capable"):
            eng.run()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


CLI = ["simulate", "--clients", "4", "--local-epochs", "1",
       "--samples-per-class", "8", "--hw", "8", "--width", "4",
       "--degree", "2", "--partition", "pathological", "--exec", "loop"]


def _ref_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    capsys.readouterr()
    ref_train.main()
    out = capsys.readouterr().out
    return json.loads(out[out.index("{\n"):])


def test_registries_match():
    assert strategy_names() == ref_strategy_names()


@pytest.mark.parametrize("name", ["dpsgd", "fedavg_ft"])
def test_cli_matches_reference(name, monkeypatch, capsys, tmp_path):
    """Both CLIs resume one reference archive (written by the reference CLI
    after round 1) and print the same summary."""
    ck = str(tmp_path / "ck.npz")
    base = CLI + ["--strategy", name]
    _ref_cli(monkeypatch, capsys, base + ["--rounds", "1", "--checkpoint", ck])
    argv = base + ["--rounds", "2", "--resume", ck]
    want = _ref_cli(monkeypatch, capsys, argv)
    got = port_train.main(argv + ["--device", "cpu"])
    for d in (want, got):
        d.pop("wall_s")
    assert got.pop("device") == "cpu"
    got.pop("round_wall_s"), got.pop("phase_s")
    assert got == want


def test_cli_unknown_strategy_fails_as_the_reference(monkeypatch, capsys):
    argv = CLI + ["--rounds", "1", "--strategy", "fedprox"]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    with pytest.raises(KeyError) as ref_err:
        ref_train.main()
    with pytest.raises(KeyError) as port_err:
        port_train.main(argv + ["--device", "cpu"])
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name", ["dpsgd", "dpsgd_ft", "local", "fedavg",
                                  "fedavg_ft", "ditto", "fomo", "subfedavg",
                                  "dfedalt", "dfedsam"])
def test_cli_runs_every_strategy_on_cpu(name, monkeypatch):
    out = port_train.main(CLI + ["--rounds", "1", "--strategy", name,
                                 "--device", "cpu"])
    assert out["strategy"] == name and out["device"] == "cpu"
    assert np.isfinite(out["final_acc"]) and out["flops"]["FLOPS_1e12"] >= 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(CLI + ["--rounds", "1", "--strategy", name])
