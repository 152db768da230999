"""Run manifests, on-disk run archives, and the benchmark history log
(reference ``repro.obs.runs``, copied line for line but for the versions a
manifest records).

A *run* is one invocation of a launcher.  This module gives every run an
identity and a durable artifact:

* ``RunManifest`` — what produced the numbers: run id, kind, creation
  time, git sha, seed, the config/argv that launched it, and the
  python/numpy/torch + schema versions that interpret it.
* ``save_run`` / ``RunArchive`` — a run directory holding
  ``manifest.json``, ``counters.json`` (``snapshot_counters()``),
  ``series.json`` (``snapshot_series()``), and optionally ``trace.json``
  (the Perfetto export) and ``report.json``.  ``launch/dash.py`` renders
  a dashboard from exactly this layout, and ``RunRegistry`` lists/loads
  archives under a root directory.  The layout and its schema versions
  are the reference's, so an archive written by either package loads and
  renders in the other; only the compile counters differ in name
  (``torch/*`` here, ``jax/*`` there).
* ``append_history`` / ``read_history`` — an append-only JSONL history:
  one timestamped, git-sha-stamped line per benchmark module plus one
  ``run`` line carrying the run's ``phase_summary`` and counter snapshot,
  which ``diff_runs`` compares to name the phase or counter that moved.

Importing this module never imports torch; the torch and CUDA versions
are recorded only when torch is already loaded in the process.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from typing import Optional

from repro_torch.obs.counters import snapshot_counters
from repro_torch.obs.export import (
    JSONL_SCHEMA_VERSION,
    TRACE_SCHEMA_VERSION,
    phase_summary,
    spans_from_trace_doc,
    write_trace,
)
from repro_torch.obs.series import SERIES_SCHEMA_VERSION, snapshot_series

MANIFEST_NAME = "manifest.json"
COUNTERS_NAME = "counters.json"
SERIES_NAME = "series.json"
TRACE_NAME = "trace.json"
REPORT_NAME = "report.json"

#: version of the run-archive directory layout
RUN_SCHEMA_VERSION = 1


def git_sha(cwd: Optional[str] = None) -> str:
    """Current git commit (short), or ``"unknown"`` outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=cwd or os.getcwd())
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _versions() -> dict:
    v = {
        "python": sys.version.split()[0],
        "runSchemaVersion": RUN_SCHEMA_VERSION,
        "traceSchemaVersion": TRACE_SCHEMA_VERSION,
        "jsonlSchemaVersion": JSONL_SCHEMA_VERSION,
        "seriesSchemaVersion": SERIES_SCHEMA_VERSION,
    }
    np = sys.modules.get("numpy")
    if np is not None:
        v["numpy"] = getattr(np, "__version__", "unknown")
    # only record torch if the run already imported it — never import it here
    torch = sys.modules.get("torch")
    if torch is not None:
        v["torch"] = getattr(torch, "__version__", "unknown")
        version = getattr(torch, "version", None)
        v["cuda"] = getattr(version, "cuda", None)
    return v


@dataclasses.dataclass
class RunManifest:
    run_id: str
    kind: str                      # train | sim | serve | bench | ...
    created: float                 # unix seconds
    git_sha: str
    seed: Optional[int] = None
    config: dict = dataclasses.field(default_factory=dict)
    argv: list = dataclasses.field(default_factory=list)
    versions: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, kind: str, run_id: Optional[str] = None,
              seed: Optional[int] = None,
              config: Optional[dict] = None,
              argv: Optional[list] = None) -> "RunManifest":
        created = time.time()
        if run_id is None:
            stamp = datetime.datetime.fromtimestamp(
                created, datetime.timezone.utc).strftime("%Y%m%d-%H%M%S")
            run_id = f"{kind}-{stamp}-{os.getpid()}"
        return cls(run_id=run_id, kind=kind, created=created,
                   git_sha=git_sha(), seed=seed, config=dict(config or {}),
                   argv=list(sys.argv if argv is None else argv),
                   versions=_versions())

    @property
    def created_iso(self) -> str:
        return datetime.datetime.fromtimestamp(
            self.created, datetime.timezone.utc).isoformat(
                timespec="seconds")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["created_iso"] = self.created_iso
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunManifest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def save_run(run_dir: str, manifest: RunManifest, tracer=None,
             report: Optional[dict] = None,
             counters: Optional[dict] = None,
             series: Optional[dict] = None) -> "RunArchive":
    """Write a run archive: manifest + counter snapshot + series snapshot,
    plus the tracer's Perfetto export and an optional report doc.

    ``counters``/``series`` override the process-wide snapshots — pass
    per-instance snapshots when other live metric sets in the process
    (e.g. a shared test run) would pollute the same keys.
    """
    os.makedirs(run_dir, exist_ok=True)

    def _dump(name: str, obj) -> None:
        with open(os.path.join(run_dir, name), "w") as f:
            json.dump(obj, f, indent=1, default=str)
            f.write("\n")

    _dump(MANIFEST_NAME, manifest.to_dict())
    _dump(COUNTERS_NAME, snapshot_counters() if counters is None else counters)
    _dump(SERIES_NAME, snapshot_series() if series is None else series)
    if tracer is not None:
        write_trace(os.path.join(run_dir, TRACE_NAME), tracer)
    if report is not None:
        _dump(REPORT_NAME, report)
    return RunArchive(run_dir)


class RunArchive:
    """Lazy reader over one run directory (the ``save_run`` layout)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._cache: dict[str, object] = {}

    def _load(self, name: str):
        if name not in self._cache:
            path = os.path.join(self.run_dir, name)
            if not os.path.exists(path):
                self._cache[name] = None
            else:
                with open(path) as f:
                    self._cache[name] = json.load(f)
        return self._cache[name]

    @property
    def exists(self) -> bool:
        return os.path.exists(os.path.join(self.run_dir, MANIFEST_NAME))

    def manifest(self) -> Optional[RunManifest]:
        d = self._load(MANIFEST_NAME)
        return None if d is None else RunManifest.from_dict(d)

    def counters(self) -> dict:
        return self._load(COUNTERS_NAME) or {}

    def series(self) -> dict:
        return self._load(SERIES_NAME) or {"series": {}, "histograms": {}}

    def trace(self) -> Optional[dict]:
        return self._load(TRACE_NAME)

    def report(self) -> Optional[dict]:
        return self._load(REPORT_NAME)

    def spans(self) -> list:
        doc = self.trace()
        return [] if doc is None else spans_from_trace_doc(doc)

    def phase_summary(self, clock: Optional[str] = None) -> dict:
        return phase_summary(self.spans(), clock=clock)


class RunRegistry:
    """Archives under one root directory, newest last."""

    def __init__(self, root: str):
        self.root = root

    def run_ids(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            ar = RunArchive(os.path.join(self.root, name))
            if ar.exists:
                m = ar.manifest()
                out.append((m.created, name))
        return [name for _, name in sorted(out)]

    def archive(self, run_id: str) -> RunArchive:
        return RunArchive(os.path.join(self.root, run_id))

    def latest(self, n: int = 1) -> list[RunArchive]:
        ids = self.run_ids()
        return [self.archive(r) for r in ids[-n:]]


# ---------------------------------------------------------------------------
# BENCH_history.jsonl — the append-only perf trajectory
# ---------------------------------------------------------------------------

def append_history(path: str, modules: dict[str, list],
                   phase_summary_doc: Optional[dict] = None,
                   counters: Optional[dict] = None,
                   sha: Optional[str] = None,
                   ts: Optional[float] = None,
                   note: str = "") -> int:
    """Append one line per benchmark module plus one ``run`` line; returns
    the number of lines written.  Existing history is never rewritten."""
    ts = time.time() if ts is None else float(ts)
    sha = git_sha() if sha is None else sha
    iso = datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).isoformat(timespec="seconds")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    n = 0
    with open(path, "a") as f:
        for module, rows in sorted(modules.items()):
            f.write(json.dumps({"event": "module", "ts": ts, "iso": iso,
                                "git_sha": sha, "module": module,
                                "rows": rows}, default=str) + "\n")
            n += 1
        run_line = {"event": "run", "ts": ts, "iso": iso, "git_sha": sha,
                    "modules": sorted(modules)}
        if note:
            run_line["note"] = note
        if phase_summary_doc is not None:
            run_line["phase_summary"] = phase_summary_doc
        if counters is not None:
            run_line["counters"] = counters
        f.write(json.dumps(run_line, default=str) + "\n")
        n += 1
    return n


def read_history(path: str, event: Optional[str] = None) -> list[dict]:
    """All history lines (optionally filtered by event kind), oldest
    first; malformed lines are skipped rather than fatal."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if event is None or rec.get("event") == event:
                out.append(rec)
    return out


def metric_history(path: str, module: str, row_name: str,
                   metric: str) -> list[tuple[float, float]]:
    """``(ts, value)`` trajectory of one benchmark metric — the series
    the dashboard's diff sparklines plot."""
    out = []
    for rec in read_history(path, event="module"):
        if rec.get("module") != module:
            continue
        for row in rec.get("rows", []):
            if row.get("name") == row_name and metric in row:
                try:
                    out.append((float(rec["ts"]), float(row[metric])))
                except (TypeError, ValueError):
                    pass
    return out


def diff_runs(old: dict, new: dict, top_k: int = 5) -> dict:
    """Rank what changed between two run-level docs, each shaped
    ``{"phase_summary": {...}, "counters": {...}}`` (a history ``run``
    line or a ``RunArchive``'s derived docs).

    Phases rank by absolute ``total_s`` delta, counters by relative
    change — the ``--attribute`` output that names the dominant cause of
    a regression instead of just the failing metric.
    """
    old_ph = old.get("phase_summary") or {}
    new_ph = new.get("phase_summary") or {}
    phases = []
    for name in sorted(set(old_ph) | set(new_ph)):
        o = float((old_ph.get(name) or {}).get("total_s", 0.0))
        nw = float((new_ph.get(name) or {}).get("total_s", 0.0))
        if o == 0.0 and nw == 0.0:
            continue
        phases.append({
            "phase": name, "old_s": o, "new_s": nw, "delta_s": nw - o,
            "ratio": (nw / o) if o > 0 else float("inf"),
        })
    phases.sort(key=lambda p: -abs(p["delta_s"]))

    old_c = old.get("counters") or {}
    new_c = new.get("counters") or {}
    counters = []
    for key in sorted(set(old_c) | set(new_c)):
        try:
            o = float(old_c.get(key, 0.0))
            nw = float(new_c.get(key, 0.0))
        except (TypeError, ValueError):
            continue
        if o == nw:
            continue
        rel = abs(nw - o) / max(abs(o), 1e-12)
        counters.append({"counter": key, "old": o, "new": nw,
                         "delta": nw - o, "rel": rel})
    counters.sort(key=lambda c: -c["rel"])
    return {"phases": phases[:top_k], "counters": counters[:top_k]}
