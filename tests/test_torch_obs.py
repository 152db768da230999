"""The port's observability plane (``repro_torch.obs``: export, health, run
archives; ``repro_torch.launch.dash``) against the reference's, from
hand-built spans, counters and series — no engine runs here
(``test_torch_obs_sim.py`` holds the engine and CLI runs).

Everything is held exactly: trace documents, rollups (sketches by
``to_dict``), health events, archives and history lines compare equal, and
dashboard pages and diffs are byte-identical, because the documents are the
interface between the two packages.
"""
import json
import os
import stat
import subprocess
import sys

import pytest

import repro.launch.dash as ref_dash
import repro.obs as ref_obs
import repro_torch.launch.dash as port_dash
import repro_torch.obs as port_obs
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.sim.report import MetricsStream as RefMetricsStream
from repro_torch.kernels import build
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.obs import counters as port_counters
from repro_torch.sim.report import MetricsStream

pytestmark = pytest.mark.tier1

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PKGS = {"port": port_obs, "ref": ref_obs}


def _fill(obs):
    """One enabled full-mode tracer of ``obs`` holding the same hand-built
    spans in either package: wall phases, virtual transfers (one
    retransmit), compute, SSP waits, uplink occupancy and a slot residency
    opened and closed on the virtual clock."""
    t = obs.Tracer()
    t.enable(mode="full")
    v, w = obs.VIRTUAL, obs.WALL
    for r in range(2):
        t.add_span("round.mix", r + 0.0, r + 0.25, track="engine", clock=w,
                   round=r)
        t.add_span("round.local", r + 0.25, r + 0.75, track="engine",
                   clock=w, round=r, active=4)
    xfers = [(0, 1, 0.1, 0.6, 0), (0, 1, 0.7, 1.2, 1), (1, 2, 0.2, 0.5, 0),
             (2, 0, 0.3, 0.9, 0), (3, 0, 0.1, 0.15, 0), (0, 3, 0.5, 1.0, 0)]
    for src, dst, t0, t1, attempt in xfers:
        t.add_span("retransmit" if attempt else "transfer", t0, t1,
                   track=f"link/{src}->{dst}", clock=v, src=src, dst=dst,
                   bytes_values=1000.0 + 7 * src, bytes_wire=1160.0 + 7 * src,
                   attempt=attempt)
        t.add_span("uplink.busy", t0, t1 - 0.01, track=f"uplink/{src}",
                   clock=v, dst=dst)
    for k, d in enumerate((1.0, 1.5, 0.2, 9.0)):
        t.add_span("compute", 0.0, d, track=f"client/{k}", clock=v, round=0)
    t.add_span("ssp.wait", 0.2, 1.3, track="client/2", clock=v)
    t.add_span("ssp.wait", 1.0, 1.05, track="client/1", clock=v)
    h = t.begin("user:3", track="slot/0", clock=v, t=1.0, user=3)
    t.end(h, t=2.5)
    return t


def _plain(x):
    """Rollups with their ``LogHistogram`` sketches as ``to_dict``."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "to_dict"):
        return x.to_dict()
    return x


def _doc(obs, tracer):
    doc = obs.to_trace_events(tracer)
    # the process-wide snapshot differs between the packages' registries
    doc["otherData"].pop("counters")
    return doc


def _series(obs):
    """A series document with a gauge, a counter series, the density pair
    and a sketch, built through ``obs``'s own ``SeriesSet`` objects."""
    ss, fl = obs.SeriesSet("t.obs"), obs.SeriesSet("fl.engine")
    for i, (m, d) in enumerate(((0.5, 0.5), (0.44, 0.48), (0.40, 0.47))):
        ss.series("acc").observe(float(i), 0.1 * i)
        ss.series("bytes", kind="counter").observe(float(i), 100.0 * i * i)
        fl.series("density_measured").observe(float(i), m)
        fl.series("density_target").observe(float(i), d)
    for x in (0.5, 1.0, 2.0, 40.0):
        ss.histogram("lat_ms").add(x)
    doc = {"series": {}, "histograms": {}}
    for cs in (ss, fl):
        for part, items in cs.snapshot().items():
            doc[part].update({f"{cs.namespace}/{k}": v
                              for k, v in items.items()})
    return doc


COUNTERS = {"sim.links/bytes_values": 6042.0, "sim.links/bytes_wire": 7002.0,
            "sim.links/n_retransmits": 1, "sim.links/transfers": 6,
            "serve.store/hits": 3, "serve.store/misses": 9,
            "serve.store/evictions": 2, "serve.store/resident": 4,
            "serve.store/bytes_at_rest": 123456, "torch/backend_compiles": 4}


def _archive(obs, path, tracer):
    manifest = obs.RunManifest.build("sim", run_id="run-a", seed=3,
                                     config={"rounds": 2}, argv=["x"])
    manifest.created = 1.7e9
    manifest.git_sha = "abc1234"
    return obs.save_run(str(path), manifest, tracer=tracer,
                        report={"final_acc": 0.5}, counters=dict(COUNTERS),
                        series=_series(obs))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def test_exports_equal_and_validate_across_packages(tmp_path):
    tp, tr = _fill(port_obs), _fill(ref_obs)
    doc_p, doc_r = _doc(port_obs, tp), _doc(ref_obs, tr)
    assert json.dumps(doc_p) == json.dumps(doc_r)
    assert port_obs.JSONL_SCHEMA_VERSION == ref_obs.JSONL_SCHEMA_VERSION
    assert port_obs.TRACE_SCHEMA_VERSION == ref_obs.TRACE_SCHEMA_VERSION
    assert port_obs.validate_trace(doc_r) == []
    assert ref_obs.validate_trace(doc_p) == []
    broken = json.loads(json.dumps(doc_r))
    broken["traceEvents"][-1]["dur"] = -1.0
    assert port_obs.validate_trace(broken) == ref_obs.validate_trace(broken)
    assert port_obs.validate_trace(broken)
    written = port_obs.write_trace(str(tmp_path / "t.json"), _fill(port_obs))
    with open(tmp_path / "t.json") as f:
        loaded = json.load(f)
    assert loaded == json.loads(json.dumps(written))
    assert ref_obs.validate_trace(loaded) == []
    back_p = [s.to_dict() for s in port_obs.spans_from_trace_doc(doc_r)]
    back_r = [s.to_dict() for s in ref_obs.spans_from_trace_doc(doc_p)]
    assert back_p == back_r and len(back_p) == len(tp.spans())
    assert port_obs.phase_summary(tp) == ref_obs.phase_summary(tr)
    assert (port_obs.phase_summary(port_obs.spans_from_trace_doc(doc_r))
            == ref_obs.phase_summary(ref_obs.spans_from_trace_doc(doc_r)))


def test_traced_decorator_matches_reference():
    for obs in (port_obs, ref_obs):
        t = obs.Tracer()
        old = obs.set_tracer(t)
        try:
            @obs.traced()
            def work(x):
                return x + 1

            @obs.traced("named", track="k")
            def other():
                return 7

            assert work(1) == 2          # disabled: no span
            t.enable(mode="full")
            assert work(2) == 3 and other() == 7
            got = [(s.name, s.track, s.clock) for s in t.spans()]
        finally:
            obs.set_tracer(old)
        assert got == [(work.__qualname__, "main", obs.WALL),
                       ("named", "k", obs.WALL)]


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rollup", ["comm_rollup", "straggler_rollup",
                                    "staleness_rollup", "uplink_rollup"])
def test_rollups_equal_across_packages(rollup):
    tp, tr = _fill(port_obs), _fill(ref_obs)
    got = _plain(getattr(port_obs, rollup)(tp))
    want = _plain(getattr(ref_obs, rollup)(tr))
    assert got == want
    # and from the other package's exported document
    doc = json.loads(json.dumps(ref_obs.to_trace_events(tr)))
    assert (_plain(getattr(port_obs, rollup)(doc))
            == _plain(getattr(ref_obs, rollup)(doc)))


def test_fleet_health_events_equal_across_packages(tmp_path):
    tp, tr = _fill(port_obs), _fill(ref_obs)
    ser = {n: _series(obs) for n, obs in PKGS.items()}
    dens = {n: (obs.TimeSeries.from_dict(
        ser[n]["series"]["fl.engine/density_measured"]),
        obs.TimeSeries.from_dict(
            ser[n]["series"]["fl.engine/density_target"]))
        for n, obs in PKGS.items()}
    th = {n: obs.HealthThresholds(max_p99_staleness_s=0.01)
          for n, obs in PKGS.items()}
    roll_p, ev_p = port_obs.fleet_health(tp, counters=COUNTERS,
                                         thresholds=th["port"],
                                         density=dens["port"],
                                         dropped_spans=2)
    roll_r, ev_r = ref_obs.fleet_health(tr, counters=COUNTERS,
                                        thresholds=th["ref"],
                                        density=dens["ref"], dropped_spans=2)
    assert _plain(roll_p) == _plain(roll_r)
    assert [e.to_dict() for e in ev_p] == [e.to_dict() for e in ev_r]
    kinds = {e.kind for e in ev_p}
    assert {"trace.dropped", "link.retransmit_rate", "compute.straggler",
            "ssp.staleness", "store.hit_ratio", "density.drift"} <= kinds
    with MetricsStream(str(tmp_path / "p.jsonl"), header=True) as s:
        port_obs.emit_health(s, ev_p)
    with RefMetricsStream(str(tmp_path / "r.jsonl"), header=True) as s:
        ref_obs.emit_health(s, ev_r)
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()


# ---------------------------------------------------------------------------
# run archives, history and attribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_run_archive_reads_in_both_packages(writer, tmp_path):
    obs = PKGS[writer]
    _archive(obs, tmp_path / "run-a", _fill(obs))
    reads = {}
    for name, reader in PKGS.items():
        ar = reader.RunArchive(str(tmp_path / "run-a"))
        assert ar.exists
        reads[name] = (ar.manifest().to_dict(), ar.counters(), ar.series(),
                       ar.trace(), ar.report(),
                       [s.to_dict() for s in ar.spans()], ar.phase_summary())
        assert reader.RunRegistry(str(tmp_path)).run_ids() == ["run-a"]
    assert reads["port"] == reads["ref"]
    assert reads["port"][1] == COUNTERS


def test_manifest_records_torch_never_jax():
    import torch

    v = port_obs.RunManifest.build("sim", seed=0).versions
    assert "jax" in sys.modules and "jax" not in v
    assert v["torch"] == torch.__version__ and v["cuda"] == torch.version.cuda
    ref_v = ref_obs.RunManifest.build("sim", seed=0).versions
    assert {k: v[k] for k in v if k not in ("torch", "cuda")} == \
        {k: ref_v[k] for k in ref_v if k != "jax"}


def test_history_and_diff_runs_equal_across_packages(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    ph = {"round.local": {"count": 3, "total_s": 3.0, "mean_s": 1.0,
                          "max_s": 1.0},
          "round.mix": {"count": 3, "total_s": 0.3, "mean_s": 0.1,
                        "max_s": 0.1}}
    port_obs.append_history(path, {"m1": [{"name": "codec", "us": 10.0}]},
                            sha="abc", ts=100.0, phase_summary_doc=ph,
                            counters={"torch/backend_compiles": 1})
    ref_obs.append_history(path, {"m1": [{"name": "codec", "us": 12.0}]},
                           sha="def", ts=200.0, counters={
                               "torch/backend_compiles": 4})
    for ev in (None, "run", "module"):
        assert (port_obs.read_history(path, event=ev)
                == ref_obs.read_history(path, event=ev))
    assert (port_obs.metric_history(path, "m1", "codec", "us")
            == ref_obs.metric_history(path, "m1", "codec", "us")
            == [(100.0, 10.0), (200.0, 12.0)])
    old, new = port_obs.read_history(path, event="run")
    assert port_obs.diff_runs(old, new) == ref_obs.diff_runs(old, new)
    assert port_obs.diff_runs(old, new)["counters"][0]["counter"] == \
        "torch/backend_compiles"


def test_obs_and_dash_import_neither_torch_nor_numpy(tmp_path):
    code = ("import sys\n"
            "import repro_torch.obs as o, repro_torch.launch.dash\n"
            "o.RunManifest.build('sim', seed=0)\n"
            "o.save_run(sys.argv[1], o.RunManifest.build('sim'))\n"
            "assert not {'torch', 'numpy', 'jax', 'repro'} & set(sys.modules),"
            " sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "r")],
                         env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the torch counter set
# ---------------------------------------------------------------------------


def test_install_torch_hooks_is_idempotent():
    cs = port_obs.install_torch_hooks()
    assert cs is port_obs.install_torch_hooks()
    assert cs.namespace == "torch"
    snap = cs.snapshot()
    assert set(snap) == {"backend_compiles", "backend_compile_s",
                         "dynamo_graphs"}
    assert snap["dynamo_graphs"] == port_obs.torch_compile_count()
    keys = port_obs.snapshot_counters(prefix="torch")
    assert set(keys) == {f"torch/{k}" for k in snap}


def test_build_all_counts_kernel_builds(tmp_path, monkeypatch):
    """Each source a ``build_all`` compiles counts once, with its seconds
    (a stand-in compiler that writes its ``-o`` file)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    cs = port_counters.install_torch_hooks()
    n0, s0 = (cs.counter("backend_compiles").value,
              cs.counter("backend_compile_s").value)
    assert set(build.build_all()) == {"a", "b"}
    assert cs.counter("backend_compiles").value == n0 + 2
    assert cs.counter("backend_compile_s").value > s0
    assert build.build_all() == {}               # built: nothing to count
    assert cs.counter("backend_compiles").value == n0 + 2


# ---------------------------------------------------------------------------
# the dashboard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_dashboard_pages_byte_identical(writer, tmp_path):
    obs = PKGS[writer]
    tracer = _fill(obs)
    _archive(obs, tmp_path / "a", tracer)
    pages = {name: dash.render_dashboard(
        archive=pkg.RunArchive(str(tmp_path / "a")))
        for (name, pkg), dash in zip(PKGS.items(), (port_dash, ref_dash))}
    assert pages["port"] == pages["ref"]
    page = pages["port"]
    assert "<script" not in page.lower() and "run run-a" in page
    doc = obs.to_trace_events(tracer)
    doc["otherData"]["counters"] = dict(COUNTERS)
    assert (port_dash.render_dashboard(trace_doc=doc)
            == ref_dash.render_dashboard(trace_doc=doc))
    for dash in (port_dash, ref_dash):
        assert dash.check_dashboard(page, doc, COUNTERS) == []
        doctored = {**COUNTERS, "sim.links/bytes_values":
                    COUNTERS["sim.links/bytes_values"] + 1.0}
        assert any("reconcile" in p for p in
                   dash.check_dashboard(page, doc, doctored))
        assert any("missing section" in p for p in dash.check_dashboard(
            "<!doctype html><html></html>", None, {}))


def test_dash_cli_render_and_diff_match_reference(tmp_path, capsys):
    for name, d in (("a", 0.25), ("b", 0.75)):
        t = _fill(port_obs)
        t.add_span("round.evolve", 5.0, 5.0 + d, track="engine",
                   clock=port_obs.WALL, round=2)
        _archive(port_obs, tmp_path / name, t)
    outs = {}
    for label, dash in (("port", port_dash), ("ref", ref_dash)):
        render = str(tmp_path / f"{label}.html")
        diff = str(tmp_path / f"{label}-diff.html")
        assert dash.main(["render", "--run-dir", str(tmp_path / "a"),
                          "-o", render, "--check"]) == 0
        assert dash.main(["diff", "--old", str(tmp_path / "a"), "--new",
                          str(tmp_path / "b"), "-o", diff]) == 0
        outs[label] = (open(render).read(), open(diff).read())
    assert outs["port"] == outs["ref"]
    assert "round.evolve" in outs["port"][1]
    assert "check ok" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the CLIs' flags
# ---------------------------------------------------------------------------


def _ref_error(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as e:
        main()
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_trace_mode_without_trace_is_the_reference_error(cli, monkeypatch,
                                                         capsys):
    pre = ["simulate", "--rounds", "1"] if cli == "train" else []
    argv = pre + ["--trace-mode", "full"]
    ref_main = {"train": ref_train.main, "serve": ref_serve.main}[cli]
    port_main = {"train": port_train.main, "serve": port_serve.main}[cli]
    want = _ref_error(monkeypatch, capsys, ref_main, argv)
    with pytest.raises(SystemExit) as e:
        port_main(argv + ["--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert e.value.code == 2
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1] == \
        "--trace-mode requires --trace or --run-dir"
