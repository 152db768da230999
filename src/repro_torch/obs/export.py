"""Trace/metrics export (reference ``repro.obs.export``, copied line for
line): Chrome/Perfetto ``trace_event`` JSON and the one place the
streaming JSONL schema is versioned.

``to_trace_events`` renders a ``Tracer``'s buffer as the Trace Event
Format both ``chrome://tracing`` and https://ui.perfetto.dev load
directly: complete ``"X"`` events with microsecond ``ts``/``dur``, one
*process* per clock domain (pid 1 = wall clock, pid 2 = the simulator's
virtual clock) and one *thread* per track (``client/3``, ``link/0->2``,
``slot/5``, ...).  Thread ids are assigned by sorted track name, so the
same run always exports the same (pid, tid) layout.

Counter state rides in ``otherData.counters`` (a ``snapshot_counters()``
taken at export time), which is what lets a trace artifact reconcile
exactly against ``LinkStats`` bytes and ``ModelStore`` hit/miss counts.

The document is the reference's, schema versions included, so a trace
written by either package validates, loads and renders in the other.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs.counters import snapshot_counters
from repro_torch.obs.trace import (
    CLOCKS,
    VIRTUAL,
    WALL,
    Span,
    Tracer,
    get_tracer,
)

#: version of the streaming JSON-lines records (MetricsStream et al.)
JSONL_SCHEMA_VERSION = 1
#: version of the exported trace document's repo-specific otherData
TRACE_SCHEMA_VERSION = 1

#: one Perfetto "process" per clock domain
CLOCK_PIDS = {WALL: 1, VIRTUAL: 2}
_CLOCK_LABELS = {WALL: "wall clock (s)", VIRTUAL: "virtual clock (sim s)"}


def to_trace_events(tracer: Optional[Tracer] = None,
                    close_open: bool = True) -> dict:
    """Render the tracer's spans as a Chrome trace_event JSON object."""
    tracer = tracer or get_tracer()
    if close_open:
        tracer.end_all()
    spans = sorted(tracer.spans(), key=lambda s: s.seq)

    tids: dict[str, dict[str, int]] = {}      # clock -> track -> tid
    for clock in CLOCKS:
        tracks = sorted({s.track for s in spans if s.clock == clock})
        tids[clock] = {track: i + 1 for i, track in enumerate(tracks)}

    events: list[dict] = []
    for clock in CLOCKS:
        if not tids[clock]:
            continue
        pid = CLOCK_PIDS[clock]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": _CLOCK_LABELS[clock]}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": pid}})
        for track, tid in tids[clock].items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": track}})
    for s in spans:
        events.append({
            "name": s.name,
            "cat": s.clock,
            "ph": "X",
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(max(s.dur, 0.0) * 1e6, 3),
            "pid": CLOCK_PIDS[s.clock],
            "tid": tids[s.clock][s.track],
            "args": dict(s.attrs),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "traceSchemaVersion": TRACE_SCHEMA_VERSION,
            "jsonlSchemaVersion": JSONL_SCHEMA_VERSION,
            "spans": len(spans),
            "droppedSpans": tracer.dropped,
            "mode": tracer.mode,
            "counters": snapshot_counters(),
        },
    }


def write_trace(path: str, tracer: Optional[Tracer] = None,
                close_open: bool = True) -> dict:
    """Export the tracer to a Perfetto-loadable JSON file; returns the
    document (callers print event counts / reconcile in tests)."""
    doc = to_trace_events(tracer, close_open=close_open)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return doc


def validate_trace(doc: dict) -> list[str]:
    """Cheap structural validation of an exported trace document (the
    invariants Perfetto's JSON importer relies on).  Returns problems —
    empty means loadable."""
    problems: list[str] = []
    if not isinstance(doc.get("traceEvents"), list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(doc["traceEvents"]):
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: missing pid")
        if ph == "X":
            for key in ("ts", "dur"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"event {i}: missing {key}")
            if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
                problems.append(f"event {i}: negative dur")
            if not isinstance(ev.get("tid"), int):
                problems.append(f"event {i}: missing tid")
    try:
        json.dumps(doc)
    except TypeError as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


_CLOCK_BY_PID = {pid: clock for clock, pid in CLOCK_PIDS.items()}


def spans_from_trace_doc(doc: dict) -> list[Span]:
    """Inverse of ``to_trace_events``: rebuild ``Span`` objects from an
    exported trace document so the health rollups (``obs.health``)
    compute identically from a live tracer and a loaded artifact.

    Track names come from the ``thread_name`` metadata events;
    timestamps return as seconds (the export's microsecond rounding
    bounds them to 1e-9 s — byte attrs, which the exact reconciliations
    sum, round-trip bit-exactly through JSON).
    """
    tracks: dict[tuple[int, int], str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    spans: list[Span] = []
    for i, ev in enumerate(doc.get("traceEvents", [])):
        if ev.get("ph") != "X":
            continue
        clock = _CLOCK_BY_PID.get(ev.get("pid"), WALL)
        track = tracks.get((ev.get("pid"), ev.get("tid")),
                           f"tid/{ev.get('tid')}")
        t0 = float(ev["ts"]) * 1e-6
        t1 = t0 + float(ev["dur"]) * 1e-6
        spans.append(Span(ev["name"], track, t0, t1, clock, i,
                          dict(ev.get("args", {}))))
    return spans


def phase_summary(spans_or_tracer=None, clock: Optional[str] = None,
                  track: Optional[str] = None) -> dict:
    """Aggregate spans by name: ``{name: {count, total_s, mean_s, max_s}}``
    — the measured side of the roofline's predicted-vs-observed table."""
    if spans_or_tracer is None:
        spans_or_tracer = get_tracer()
    spans = (spans_or_tracer.spans(clock=clock, track=track)
             if isinstance(spans_or_tracer, Tracer) else
             [s for s in spans_or_tracer
              if (clock is None or s.clock == clock)
              and (track is None or s.track == track)])
    out: dict[str, dict] = {}
    for s in spans:
        agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += max(s.dur, 0.0)
        agg["max_s"] = max(agg["max_s"], s.dur)
    for agg in out.values():
        agg["mean_s"] = agg["total_s"] / agg["count"]
    return out
