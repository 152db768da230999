"""DisPFL's configurations (capacities, ring, fc with drops, momentum) on
the port's loop engine against the reference, and resumed runs of
fedavg, ditto and dfedalt (bit-identical, archives interchanged), on the
CPU, each run from one reference archive written by ``RoundEngine.save``
before round 0.

World: K=4, smallcnn width 4, hw 8, pathological 2 classes per client,
24 train per class, 3 rounds, 1 local epoch, batch 16, degree 2 — the
reference's ``tests/test_partial.py`` world, run one round longer.

Tolerances:
- exact: masks, comm rows, FLOPs, lr, prune rate, the accuracy history and
  the final accuracies, FOMO's zero/non-zero utility pattern;
- parameters within ``PARAM_ATOL`` = 1e-7, the largest gap measured
  over the ten strategies, dpsgd's shared mask, DisPFL's four
  configurations and the resumed runs after 3 rounds being 6.0e-8 (fp32
  rounding of the convolutions: the strategies' own sums are bit-equal on
  equal inputs); FOMO in its 10-class world within ``FOMO_ATOL`` = 5e-7
  (1.8e-7 measured);
- FOMO's utilities: the zero pattern exact, the loss gaps within
  ``LOSS_GAP_ATOL`` = 1e-6 (a few ulps of an fp32 loss), the norms within
  ``NORM_RTOL``;
- resumed runs bit for bit.
"""

import numpy as np
import pytest

from repro.data import build_federated_image_task as ref_build
from repro.fl import FLConfig as RefFLConfig
from repro.fl import RoundEngine as RefRoundEngine
from repro.fl import make_cnn_task as ref_make_task
from repro.fl import make_strategy as ref_make_strategy
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import Checkpointer, RoundEngine, make_strategy
from repro_torch.utils.tree import tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-7
FOMO_ATOL = 5e-7
# FOMO: a loss gap is the difference of two fp32 losses near 2.3, where one
# ulp is 2.4e-7; norms are fp32 sums of squares over 10^4 coordinates
LOSS_GAP_ATOL = 1e-6
NORM_RTOL = 1e-5
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=1, batch_size=16, degree=2,
           eval_every=1)
NEW = ["dpsgd", "dpsgd_ft", "local", "fedavg", "fedavg_ft", "ditto", "fomo",
       "subfedavg", "dfedalt", "dfedsam"]


def _ref_np(tree):
    return {p: np.asarray(x) for p, x in ref_leaves(tree)}


def _port_np(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_leaves_with_path(tree)}


def _assert_state(ref_state, port_state, atol):
    """Masks exact, everything else within ``atol``; returns the largest
    parameter difference."""
    a, b = _ref_np(ref_state), _port_np(port_state)
    assert list(a) == list(b)
    gap = 0.0
    for k in a:
        if k.startswith("masks"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=k)
            gap = max(gap, float(np.abs(a[k] - b[k]).max()))
    return gap


def _metrics(m):
    d = m.to_dict()
    d.pop("wall_s")
    return d


def _pair(name, tmp_path, cfg=None, data=None, **kw):
    """A reference and a port loop engine on one world, the port restored
    from the reference's round-0 archive."""
    cfg = dict(CFG, **(cfg or {}))
    data = dict(DATA, **(data or {}))
    ref = RefRoundEngine(ref_make_strategy(name, **kw),
                         ref_make_task("smallcnn", 10, 8, width=4),
                         ref_build(0, **data)[0], RefFLConfig(**cfg),
                         local_exec="loop")
    archive = str(tmp_path / f"{name}-r0.npz")
    ref.save(archive)
    port = RoundEngine(make_strategy(name, **kw),
                       make_cnn_task("smallcnn", 10, 8, width=4, device="cpu"),
                       build_federated_image_task(0, **data)[0],
                       FLConfig(**cfg), local_exec="loop")
    port.restore(archive)
    return ref, port, archive


def _run_pair(ref, port, atol):
    """Both engines round by round: metrics equal, state within ``atol``
    after every round; returns the largest parameter gap."""
    gap, n = 0.0, 0
    for a, b in zip(ref.rounds(), port.rounds()):
        assert _metrics(a) == _metrics(b), a.round
        gap = max(gap, _assert_state(ref.state, port.state, atol))
        n += 1
    assert n == ref.cfg.rounds
    assert ref.result().final_accs == port.result().final_accs
    return gap


@pytest.mark.parametrize("cfg", [
    pytest.param(dict(capacities=[0.2, 0.4, 0.6, 0.8]), id="capacities"),
    pytest.param(dict(topology="ring"), id="ring"),
    pytest.param(dict(topology="fc", drop_prob=0.3), id="fc-drop0.3"),
    pytest.param(dict(momentum=0.9), id="momentum0.9"),
])
def test_dispfl_configurations_match_reference(cfg, tmp_path):
    ref, port, _ = _pair("dispfl", tmp_path, cfg=cfg)
    gap = _run_pair(ref, port, PARAM_ATOL)
    print(f"dispfl {cfg}: largest param gap {gap}")


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


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


def _bit_equal(a_state, b_state):
    a, b = _port_np(a_state), _port_np(b_state)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", ["fedavg", "ditto", "dfedalt"])
def test_resume_bit_identical_and_archives_interchange(name, tmp_path):
    ref, full, start = _pair(name, tmp_path)
    want = [_metrics(m) for m in full.rounds()]
    mid = str(tmp_path / "port-mid.npz")
    first = RoundEngine(make_strategy(name), full.task, full.clients,
                        full.cfg, local_exec="loop",
                        callbacks=[_SaveAt(mid, 0)]).restore(start)
    got = [_metrics(next(first.rounds()))]
    assert not any(k.startswith("_") for k in first.state)
    resumed = RoundEngine(make_strategy(name), full.task, full.clients,
                          full.cfg, local_exec="loop").restore(mid)
    got += [_metrics(m) for m in resumed.rounds()]
    assert got == want
    _bit_equal(resumed.state, full.state)
    # the port's archive goes on in the reference, and the reference's
    # archive of the same round in the port
    ref_mid = str(tmp_path / "ref-mid.npz")
    ref_first = RefRoundEngine(ref_make_strategy(name), ref.task, ref.clients,
                               ref.cfg, local_exec="loop").restore(start)
    next(ref_first.rounds())
    ref_first.save(ref_mid)
    ref_on_port = RefRoundEngine(ref_make_strategy(name), ref.task,
                                 ref.clients, ref.cfg,
                                 local_exec="loop").restore(mid)
    port_on_ref = RoundEngine(make_strategy(name), full.task, full.clients,
                              full.cfg, local_exec="loop").restore(ref_mid)
    assert ref_on_port._next_round == port_on_ref._next_round == 1
    for a, b in zip(ref_on_port.rounds(), port_on_ref.rounds()):
        assert _metrics(a) == _metrics(b)
    _assert_state(ref_on_port.state, port_on_ref.state, PARAM_ATOL)
    _assert_state(ref_on_port.state, full.state, PARAM_ATOL)
