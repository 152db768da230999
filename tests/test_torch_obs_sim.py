"""The port's observability plane on real runs, against the reference's:
a traced lossy async simulation from one reference state, the CLIs'
``--run-dir`` archives rendered and checked by both dashboards, and the
round spans closing after the device synchronise.

World of ``tests/test_obs_health.py``: K=4, smallcnn width 4, hw 8,
pathological 2 classes per client, 24 train per class, 3 rounds, 2 local
epochs, batch 16, degree 2; ``mode="async"``, staleness 1, a fair uplink,
``LossModel(0.3, timeout_s=0.05)``.  Initial params and masks come from
``jax.random``, which torch cannot replay, so the port starts from one
reference archive (as in ``test_torch_sim.py``).

Tolerances: none.  The rollups read the virtual-clock spans, whose times
and byte attributes are the simulator's own floats, which the port
reproduces exactly (``test_torch_sim.py``), so rollups (sketches by
``to_dict``), health events and counter values compare equal, and each
package's comm rollup reconciles bit for bit with its own ``LinkStats``.
Archives are written and read across the packages; a page rendered from
one archive is byte-identical whichever package renders it.

Run archives hold process-wide counter snapshots, as the reference's CLIs
write them, so the CLI tests run with no other simulator alive in the
process and with the cumulative module counters reset first.
"""
import gc
import json
import sys

import numpy as np
import pytest
import torch

import repro.launch.dash as ref_dash
import repro.obs as ref_obs
import repro_torch.launch.dash as port_dash
import repro_torch.obs as port_obs
from repro.data import build_federated_image_task as ref_build
from repro.fl import FLConfig as RefFLConfig
from repro.fl import make_cnn_task as ref_make_task
from repro.fl import make_strategy as ref_make_strategy
from repro.launch import train as ref_train
from repro.sim import LossModel as RefLossModel
from repro.sim import SimEngine as RefSimEngine
from repro.sparse import codec as ref_codec
from repro.sparse import ops as ref_ops
from repro.sparse import packed as ref_packed
from repro_torch.checkpoint.npz import load_pytree
from repro_torch.data.loader import build_federated_image_task
from repro_torch.fl import engine as port_engine
from repro_torch.fl.base import FLConfig, make_cnn_task
from repro_torch.fl.engine import RoundEngine, make_strategy
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.sim import LossModel, SimEngine
from repro_torch.sparse import codec as port_codec
from repro_torch.sparse import ops as port_ops
from repro_torch.sparse import packed as port_packed

pytestmark = pytest.mark.tier1

PKGS = {"port": port_obs, "ref": ref_obs}
DASH = {"port": port_dash, "ref": ref_dash}
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=2, batch_size=16, degree=2,
           eval_every=1)
LOSSY = dict(mode="async", staleness=1, uplink="fair", local_exec="loop")
ROLLUPS = ("comm_rollup", "straggler_rollup", "staleness_rollup",
           "uplink_rollup")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These runs are hundreds of small eager ops; under the suite's
    parallel workers torch's intra-op threads only contend for the cores,
    so the module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """Rollups with their ``LogHistogram`` sketches as ``to_dict``."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "to_dict"):
        return x.to_dict()
    return x


def _traced_run(obs, engine):
    """Run ``engine`` under a fresh full-mode default tracer of ``obs``;
    returns what the tests read, so the engine itself can be dropped: the
    tracer, per-instance counter and series snapshots (the process-wide
    snapshot would sum every live engine's keys) and the link totals."""
    t = obs.Tracer()
    old = obs.set_tracer(t)
    t.enable(mode="full")
    try:
        for _ in engine.rounds():
            pass
    finally:
        obs.set_tracer(old)
    stats = engine.stats
    counters = {f"sim.links/{k}": v for k, v in stats.obs.snapshot().items()}
    counters.update({f"fl.engine/{k}": v
                     for k, v in engine.obs.snapshot().items()})
    series = {"series": {f"sim.engine/{n}": d for n, d in
                         engine.sim_series.snapshot()["series"].items()}}
    return dict(tracer=t, counters=counters, series=series,
                up=stats.up.copy(), down=stats.down.copy(),
                up_wire=stats.up_wire.copy(),
                n_retransmits=stats.n_retransmits,
                n_transfers=len(stats.transfers))


@pytest.fixture(scope="module")
def lossy(tmp_path_factory):
    """The reference's lossy async run and the port's from the same
    reference state, each traced in full; no engine outlives the fixture
    body."""
    d = tmp_path_factory.mktemp("obs_sim")
    clients = ref_build(0, **DATA)[0]
    task = ref_make_task("smallcnn", 10, 8, width=4)
    cfg = RefFLConfig(**CFG)
    archive = str(d / "r0.npz")
    RefSimEngine(ref_make_strategy("dispfl"), task, clients, cfg,
                 mode="sync").save(archive)
    ref = RefSimEngine(ref_make_strategy("dispfl"), task, clients, cfg,
                       loss=RefLossModel(0.3, timeout_s=0.05, seed=0),
                       **LOSSY)
    runs = {"ref": _traced_run(ref_obs, ref)}
    port = SimEngine(make_strategy("dispfl"),
                     make_cnn_task("smallcnn", 10, 8, width=4, device="cpu"),
                     build_federated_image_task(0, **DATA)[0],
                     FLConfig(**CFG), loss=LossModel(0.3, timeout_s=0.05,
                                                     seed=0), **LOSSY)
    RoundEngine._restore_payload(port, load_pytree(archive))
    runs["port"] = _traced_run(port_obs, port)
    del ref, port
    gc.collect()
    return runs


@pytest.mark.parametrize("rollup", ROLLUPS)
def test_lossy_rollups_equal_reference(lossy, rollup):
    got = getattr(port_obs, rollup)(lossy["port"]["tracer"])
    want = getattr(ref_obs, rollup)(lossy["ref"]["tracer"])
    assert _plain(got) == _plain(want)
    if rollup == "comm_rollup":
        assert got["n_retransmits"] > 0 and got["n_transfers"] > 0
    if rollup == "uplink_rollup":
        assert got["busy_s"]


def test_lossy_fleet_health_equal_reference(lossy):
    _, got = port_obs.fleet_health(lossy["port"]["tracer"],
                                   counters=lossy["port"]["counters"])
    _, want = ref_obs.fleet_health(lossy["ref"]["tracer"],
                                   counters=lossy["ref"]["counters"])
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    ev = next(e for e in got if e.kind == "link.retransmit_rate")
    assert ev.severity == "critical"          # 30% loss, > 2x the 5% rule


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_comm_rollup_reconciles_with_its_linkstats(lossy, pkg):
    run, obs = lossy[pkg], PKGS[pkg]
    comm = obs.comm_rollup(run["tracer"])
    for k in range(CFG["n_clients"]):
        assert comm["up_bytes"].get(k, 0.0) == run["up"][k]     # bit-exact
        assert comm["down_bytes"].get(k, 0.0) == run["down"][k]
        assert comm["up_wire_bytes"].get(k, 0.0) == run["up_wire"][k]
    c = run["counters"]
    assert sum(comm["up_bytes"].values()) == c["sim.links/bytes_values"]
    assert sum(comm["up_wire_bytes"].values()) == c["sim.links/bytes_wire"]
    assert comm["n_retransmits"] == c["sim.links/n_retransmits"] == \
        run["n_retransmits"]
    assert comm["n_transfers"] == c["sim.links/transfers"] == \
        run["n_transfers"]
    assert lossy["port"]["counters"] == lossy["ref"]["counters"]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_lossy_archive_pages_identical_and_checked(lossy, writer, tmp_path):
    obs, run = PKGS[writer], lossy[writer]
    manifest = obs.RunManifest.build("sim", seed=0)
    obs.save_run(str(tmp_path / "run"), manifest, tracer=run["tracer"],
                 counters=run["counters"], series=run["series"])
    pages = {n: DASH[n].render_dashboard(
        archive=PKGS[n].RunArchive(str(tmp_path / "run"))) for n in PKGS}
    assert pages["port"] == pages["ref"]
    ar = port_obs.RunArchive(str(tmp_path / "run"))
    doctored = {**ar.counters(), "sim.links/n_retransmits":
                ar.counters()["sim.links/n_retransmits"] + 1}
    for dash in DASH.values():
        assert dash.check_dashboard(pages["port"], ar.trace(),
                                    ar.counters()) == []
        assert any("reconcile" in p for p in dash.check_dashboard(
            pages["port"], ar.trace(), doctored))


# ---------------------------------------------------------------------------
# round spans close after the phase's device synchronise
# ---------------------------------------------------------------------------


def test_round_spans_close_after_their_synchronise(monkeypatch):
    """Each ``round.mix/local/evolve`` span holds a ``synchronize`` call:
    on the card the span then covers the phase's device work, not only its
    launch."""
    tracer = port_obs.Tracer()
    calls = []
    monkeypatch.setattr(port_engine, "synchronize",
                        lambda device: calls.append(tracer.now()))
    eng = RoundEngine(make_strategy("dispfl"),
                      make_cnn_task("smallcnn", 10, 8, width=4, device="cpu"),
                      build_federated_image_task(0, **DATA)[0],
                      FLConfig(**{**CFG, "rounds": 1, "local_epochs": 1}),
                      local_exec="loop")
    old = port_obs.set_tracer(tracer)
    tracer.enable(mode="full")
    try:
        eng.run()
    finally:
        port_obs.set_tracer(old)
    phases = [s for s in tracer.spans() if s.name in
              ("round.mix", "round.local", "round.evolve")]
    assert [s.name for s in phases] == ["round.mix", "round.local",
                                        "round.evolve"]
    for s in phases:
        assert any(s.t0 <= t <= s.t1 for t in calls), s.name
    # every phase still timed: the spans' order is the phases' order
    assert list(eng.phase_s[0]) == ["mix", "local", "evolve", "eval"]


# ---------------------------------------------------------------------------
# the CLIs' run archives
# ---------------------------------------------------------------------------

CLI = ["simulate", "--sim", "--strategy", "dispfl_anneal", "--rounds", "2",
       "--clients", "4", "--local-epochs", "1", "--samples-per-class", "24",
       "--hw", "8", "--width", "4", "--batch-size", "16", "--degree", "2",
       "--partition", "pathological", "--exec", "loop", "--eval-every", "2",
       "--loss-prob", "0.3", "--uplink-mode", "fair", "--trace-mode", "full"]
# keys whose values depend on each package's compiler, not on the run
COMPILE_NS = {"port": "torch/", "ref": "jax/"}


def _reset_module_counters():
    """The cumulative per-process counters of both packages to 0 (the
    sparse codec, packed and ops sets count since the process began)."""
    for ops in (ref_ops, port_ops):
        ops.reset_counters()
    for mod in (ref_codec, ref_packed, port_codec, port_packed):
        mod.OBS.reset()


@pytest.fixture()
def clean_process():
    """No simulator or engine of an earlier test alive, the module counters
    at 0, fresh default tracers (the CLIs enable and keep them), and the
    compile counter sets of both packages installed, so both archives
    carry them."""
    # pytest keeps the last failed test's traceback, and with it that
    # test's locals, for post-mortem debugging
    for name in ("last_exc", "last_type", "last_value", "last_traceback"):
        if hasattr(sys, name):
            delattr(sys, name)
    gc.collect()
    for obs in PKGS.values():
        assert not obs.snapshot_counters(prefix="sim.links"), \
            "a simulator from an earlier test is still alive"
    ref_obs.install_jax_hooks()
    port_obs.install_torch_hooks()
    _reset_module_counters()
    old = {n: obs.set_tracer(obs.Tracer()) for n, obs in PKGS.items()}
    yield
    for n, obs in PKGS.items():
        obs.set_tracer(old[n])


def _archive_keys(counters, pkg):
    ns = COMPILE_NS[pkg]
    return ({k for k in counters if not k.startswith(ns)},
            {k[len(ns):] for k in counters if k.startswith(ns)})


def test_sim_cli_archives_cross_render_and_check(clean_process, tmp_path,
                                                 monkeypatch, capsys):
    """Both CLIs run ``simulate --sim --run-dir`` from one reference state;
    each archive passes both dashboards' ``--check`` with byte-identical
    pages, and the archived counters agree key for key (``torch/*`` for
    ``jax/*``) and value for value outside the compile counters."""
    r0 = str(tmp_path / "r0.npz")
    RefSimEngine(ref_make_strategy("dispfl_anneal"),
                 ref_make_task("smallcnn", 10, 8, width=4),
                 ref_build(0, n_clients=4, partition="pathological",
                           classes_per_client=2, n_train_per_class=24,
                           hw=8)[0],
                 RefFLConfig(n_clients=4, rounds=2, local_epochs=1,
                             batch_size=16, degree=2, eval_every=2),
                 mode="sync").save(r0)
    runs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    monkeypatch.setattr(sys, "argv", ["train.py"] + CLI + [
        "--resume", r0, "--run-dir", runs["ref"]])
    ref_train.main()
    _reset_module_counters()
    gc.collect()
    out = port_train.main(CLI + ["--resume", r0, "--run-dir", runs["port"],
                                 "--device", "cpu"])
    assert out["sim"]["mode"] == "sync"
    capsys.readouterr()

    counters = {n: port_obs.RunArchive(d).counters() for n, d in runs.items()}
    (plain_p, comp_p), (plain_r, comp_r) = (_archive_keys(counters["port"],
                                                          "port"),
                                            _archive_keys(counters["ref"],
                                                          "ref"))
    assert plain_p == plain_r and comp_r <= comp_p
    for ns in ("fl.engine/", "sparse.ops/", "sparse.packed/", "sparse.codec/",
               "sim.links/"):
        got = {k: v for k, v in counters["port"].items() if k.startswith(ns)}
        want = {k: v for k, v in counters["ref"].items() if k.startswith(ns)}
        assert got == want and got, ns
    assert counters["port"]["sim.links/n_retransmits"] > 0
    assert counters["port"]["sparse.packed/tree_unpacks"] > 0
    with open(f"{runs['port']}/health.jsonl") as f:
        port_health = f.read()
    with open(f"{runs['ref']}/health.jsonl") as f:
        assert port_health == f.read()
    assert json.loads(port_health.splitlines()[0]) == {
        "event": "schema", "version": port_obs.JSONL_SCHEMA_VERSION}

    for n, run_dir in runs.items():
        pages = []
        for label, dash in DASH.items():
            page = str(tmp_path / f"{n}-{label}.html")
            assert dash.main(["render", "--run-dir", run_dir, "-o", page,
                              "--check"]) == 0, (n, label)
            pages.append(open(page).read())
        assert pages[0] == pages[1]
    assert capsys.readouterr().out.count("check ok") == 4
    manifest = port_obs.RunArchive(runs["port"]).manifest()
    assert manifest.kind == "sim" and "torch" in manifest.versions
    assert "jax" not in manifest.versions


def test_serve_cli_archive_store_rollup(clean_process, tmp_path, capsys):
    run_dir = str(tmp_path / "serve")
    summary = port_serve.main([
        "--device", "cpu", "--users", "8", "--cache-size", "4",
        "--max-batch", "4", "--requests", "32", "--rows", "2",
        "--backend", "kernel", "--run-dir", run_dir,
        "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    ar = port_obs.RunArchive(run_dir)
    counters = ar.counters()
    store = port_obs.store_rollup(counters)
    assert store["hits"] == counters["serve.store/hits"] == \
        summary["store_hits"]
    assert store["misses"] == counters["serve.store/misses"] == \
        summary["store_misses"] > 0
    assert store["evictions"] == counters["serve.store/evictions"]
    assert store["bytes_at_rest"] == counters["serve.store/bytes_at_rest"]
    assert ar.report() == summary and ar.manifest().kind == "serve"
    names = {s.name for s in ar.spans()}
    assert {"serve.launch", "serve.forward", "store.miss_decode",
            "request.wait"} <= names
    page = port_dash.render_dashboard(archive=ar)
    assert page == ref_dash.render_dashboard(
        archive=ref_obs.RunArchive(run_dir))
    assert port_dash.check_dashboard(page, ar.trace(), counters) == []
    assert "store hit ratio" in page or "model store" in page
    assert np.isfinite(summary["p50_ms"])
    capsys.readouterr()
