"""Static fleet-health dashboard rendered from a run archive or trace
(reference ``repro.launch.dash``, copied line for line).

One self-contained HTML file — inline CSS, inline SVG sparklines, zero
JavaScript and zero network fetches — so the artifact opens anywhere and
renders identically forever.  Everything on the page is *derived* from the
run's durable artifacts via ``repro_torch.obs``:

* fleet rollups (busiest node, stragglers, retransmit rates, SSP
  staleness, store hit ratio) come from ``obs.health`` over the archived
  trace spans;
* sparklines come from the archived ``snapshot_series()`` doc;
* latency/transfer percentiles come from the archived ``LogHistogram``
  sketches;
* the phase table comes from ``obs.export.phase_summary``.

Archives and traces are the reference's layout, so this module renders
and checks an archive written by either package, and the page it writes
for an archive is byte-identical to the reference's page for the same
archive (its footer and subtitle included).

Modes::

    # render a dashboard from a run archive (launch/train.py --run-dir)
    PYTHONPATH=src python -m repro_torch.launch.dash render \
        --run-dir runs/sim-20260808-... -o dash.html

    # or straight from a bare Perfetto trace (launch/train.py --trace)
    PYTHONPATH=src python -m repro_torch.launch.dash render \
        --trace trace.json -o dash.html --check

    # cross-run diff: two run archives, or the two newest history runs
    PYTHONPATH=src python -m repro_torch.launch.dash diff \
        --old runs/a --new runs/b -o diff.html

``--check`` validates the rendered artifact (structure + required
sections) and, when the span buffer is complete, reconciles the page's
busiest-node/retransmit numbers exactly against the archived
``sim.links`` counters.
"""
from __future__ import annotations

import argparse
import html
import json
import math
from typing import Optional, Sequence

from repro_torch.obs import (
    HealthThresholds,
    LogHistogram,
    RunArchive,
    TimeSeries,
    diff_runs,
    fleet_health,
    phase_summary,
    read_history,
    spans_from_trace_doc,
)

# ---------------------------------------------------------------------------
# design tokens (reference palette; status colors are reserved for state
# and always ship with an icon + label, never color alone)
# ---------------------------------------------------------------------------

_CSS = """
:root {
  --surface: #fcfcfb; --ink: #0b0b0b; --ink-2: #52514e; --ink-3: #898781;
  --grid: #e1e0d9; --series: #2a78d6;
  --good: #0ca30c; --warning: #fab219; --serious: #ec835a;
  --critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root {
    --surface: #1a1a19; --ink: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
    --grid: #2c2c2a; --series: #3987e5;
  }
}
[data-theme="light"] {
  --surface: #fcfcfb; --ink: #0b0b0b; --ink-2: #52514e; --ink-3: #898781;
  --grid: #e1e0d9; --series: #2a78d6;
}
[data-theme="dark"] {
  --surface: #1a1a19; --ink: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
  --grid: #2c2c2a; --series: #3987e5;
}
html { background: var(--surface); }
body {
  font-family: system-ui, -apple-system, sans-serif;
  color: var(--ink); background: var(--surface);
  margin: 2rem auto; max-width: 72rem; padding: 0 1rem;
  font-size: 14px; line-height: 1.45;
}
h1 { font-size: 1.35rem; margin: 0 0 .25rem; }
h2 { font-size: 1.02rem; margin: 2rem 0 .5rem; }
.sub { color: var(--ink-2); margin: 0 0 1rem; }
.meta { color: var(--ink-3); font-size: .85rem; }
table { border-collapse: collapse; width: 100%; margin: .5rem 0 1rem; }
th {
  text-align: left; color: var(--ink-2); font-weight: 600;
  border-bottom: 1px solid var(--grid); padding: .3rem .6rem .3rem 0;
}
td {
  border-bottom: 1px solid var(--grid); padding: .3rem .6rem .3rem 0;
  font-variant-numeric: tabular-nums;
}
td.num, th.num { text-align: right; }
.cards { display: flex; flex-wrap: wrap; gap: 1rem; }
.card {
  border: 1px solid var(--grid); border-radius: 6px;
  padding: .7rem .9rem; min-width: 15rem;
}
.card .name { color: var(--ink-2); font-size: .85rem; }
.card .big {
  font-size: 1.3rem; font-variant-numeric: tabular-nums; margin: .1rem 0;
}
.spark polyline { stroke: var(--series); fill: none; stroke-width: 2; }
.spark .dot { fill: var(--series); }
.spark .base { stroke: var(--grid); stroke-width: 1; }
.status { font-weight: 600; white-space: nowrap; }
.status.good { color: var(--good); }
.status.warning { color: var(--warning); }
.status.serious { color: var(--serious); }
.status.critical { color: var(--critical); }
.delta-up { color: var(--serious); font-weight: 600; }
.delta-down { color: var(--good); font-weight: 600; }
"""

#: status severities always render icon + label (never color alone)
_STATUS_ICON = {"good": "●", "warning": "▲",
                "serious": "◆", "critical": "✖"}


def _esc(x) -> str:
    return html.escape(str(x))


def _fmt(v, nd: int = 3) -> str:
    """Human number: trims float noise, keeps ints exact."""
    if v is None:
        return "–"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            return str(v)
        if v == int(v) and abs(v) < 1e15:
            return f"{int(v):,}"
        return f"{v:,.{nd}f}"
    if isinstance(v, int):
        return f"{v:,}"
    return _esc(v)


def _status(severity: str) -> str:
    icon = _STATUS_ICON.get(severity, "●")
    return (f'<span class="status {_esc(severity)}">{icon}'
            f' {_esc(severity)}</span>')


def _table(headers: Sequence[str], rows: Sequence[Sequence],
           numeric_from: int = 1) -> str:
    """Rows render escaped unless a cell is pre-marked safe by wrapping
    it in a one-element tuple (already-escaped HTML)."""
    num_cls = ' class="num"'
    th = "".join(
        f"<th{num_cls if i >= numeric_from else ''}>{_esc(h)}</th>"
        for i, h in enumerate(headers))
    body = []
    for row in rows:
        tds = []
        for i, cell in enumerate(row):
            safe = isinstance(cell, tuple)
            text = cell[0] if safe else _fmt(cell)
            cls = ' class="num"' if i >= numeric_from else ""
            tds.append(f"<td{cls}>{text}</td>")
        body.append("<tr>" + "".join(tds) + "</tr>")
    return (f"<table><thead><tr>{th}</tr></thead>"
            f"<tbody>{''.join(body)}</tbody></table>")


# ---------------------------------------------------------------------------
# inline SVG sparkline (single series — the card title names it, so no
# legend; native <title> tooltip keeps the page JS-free)
# ---------------------------------------------------------------------------

def _sparkline(points: Sequence[tuple], w: int = 220, h: int = 44) -> str:
    pts = [(float(t), float(v)) for t, v in points]
    if len(pts) < 2:
        return '<div class="meta">not enough samples</div>'
    t0, t1 = pts[0][0], pts[-1][0]
    vs = [v for _, v in pts]
    v0, v1 = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (v1 - v0) or 1.0
    pad = 4
    coords = " ".join(
        f"{pad + (t - t0) / tspan * (w - 2 * pad):.1f},"
        f"{h - pad - (v - v0) / vspan * (h - 2 * pad):.1f}"
        for t, v in pts)
    lx, ly = coords.rsplit(" ", 1)[-1].split(",")
    tooltip = (f"{len(pts)} samples, min {_fmt(v0)}, max {_fmt(v1)}, "
               f"last {_fmt(pts[-1][1])}")
    return (
        f'<svg class="spark" width="{w}" height="{h}" '
        f'viewBox="0 0 {w} {h}" role="img">'
        f"<title>{_esc(tooltip)}</title>"
        f'<line class="base" x1="{pad}" y1="{h - pad}" '
        f'x2="{w - pad}" y2="{h - pad}"/>'
        f'<polyline points="{coords}"/>'
        f'<circle class="dot" cx="{lx}" cy="{ly}" r="3"/></svg>')


def _series_cards(series_doc: dict) -> str:
    cards = []
    for key in sorted(series_doc.get("series", {})):
        d = series_doc["series"][key]
        pts = d.get("points", [])
        last = pts[-1][1] if pts else None
        kind = d.get("kind", "gauge")
        cards.append(
            '<div class="card">'
            f'<div class="name">{_esc(key)} '
            f'<span class="meta">({_esc(kind)}, {_esc(d.get("clock"))} '
            f"clock)</span></div>"
            f'<div class="big">{_fmt(last)}</div>'
            f"{_sparkline(pts)}</div>")
    if not cards:
        return '<p class="meta">no series in this archive</p>'
    return f'<div class="cards">{"".join(cards)}</div>'


def _histogram_table(series_doc: dict) -> str:
    rows = []
    for key in sorted(series_doc.get("histograms", {})):
        h = LogHistogram.from_dict(series_doc["histograms"][key])
        rows.append([key, h.count, _fmt(h.mean), _fmt(h.quantile(0.5)),
                     _fmt(h.quantile(0.9)), _fmt(h.quantile(0.99)),
                     _fmt(h.max if h.count else None)])
    if not rows:
        return '<p class="meta">no histograms in this archive</p>'
    return _table(["sketch", "count", "mean", "p50", "p90", "p99", "max"],
                  rows)


# ---------------------------------------------------------------------------
# dashboard sections
# ---------------------------------------------------------------------------

def _health_section(events) -> str:
    if not events:
        return (f'<p>{_status("good")} '
                "no health thresholds tripped</p>")
    rows = [[(_status(ev.severity),), ev.kind, (_esc(ev.message),),
             _fmt(ev.value), _fmt(ev.threshold)] for ev in events]
    return _table(["status", "rule", "detail", "value", "threshold"],
                  rows, numeric_from=3)


def _comm_section(comm: dict) -> str:
    if not comm["n_transfers"]:
        return '<p class="meta">no transfer spans in this run</p>'
    head = _table(
        ["metric", "value"],
        [["busiest node",
          f"node {comm['busiest_node']} "
          f"({_fmt(comm['busiest_node_mb'])} MB)"],
         ["mean per-node MB", _fmt(comm["mean_node_mb"])],
         ["total MB (values)", _fmt(comm["total_mb"])],
         ["transfers", comm["n_transfers"]],
         ["retransmits", comm["n_retransmits"]],
         ["retransmit rate", f"{comm['retransmit_rate']:.2%}"],
         ["retransmitted MB", _fmt(comm["retrans_mb"])]])
    top = _table(["node", "busiest-direction MB"],
                 [[f"node {k}", _fmt(mb)] for k, mb in comm["top_nodes"]])
    links = ""
    if comm["n_retransmits"]:
        links = ("<h3>worst links by retransmit rate</h3>"
                 + _table(["link", "retransmit rate"],
                          [[link, f"{r:.2%}"]
                           for link, r in comm["worst_links"] if r > 0]))
    xh = comm["transfer_s"]
    xfer = _table(
        ["transfer seconds", "count", "p50", "p90", "p99"],
        [["(from spans)", xh.count, _fmt(xh.quantile(0.5)),
          _fmt(xh.quantile(0.9)), _fmt(xh.quantile(0.99))]])
    return head + "<h3>top nodes</h3>" + top + links + xfer


def _straggler_section(strag: dict) -> str:
    if not strag["n_clients"]:
        return '<p class="meta">no compute spans in this run</p>'
    rows = [[f"client {k}", _fmt(s),
             _fmt(s / strag["mean_compute_s"], 2)
             if strag["mean_compute_s"] else "–"]
            for k, s in strag["top_stragglers"]]
    return _table(["client", "compute s", "x mean"], rows)


def _staleness_section(stale: dict) -> str:
    if not stale["n_waits"]:
        return '<p class="meta">no ssp.wait spans (synchronous run)</p>'
    h = stale["wait_s"]
    return _table(
        ["SSP waits", "total s", "p50 s", "p99 s"],
        [[stale["n_waits"], _fmt(stale["total_wait_s"]),
          _fmt(h.quantile(0.5)), _fmt(stale["p99_wait_s"])]])


def _uplink_section(up: dict) -> str:
    if not up["busy_s"]:
        return '<p class="meta">no uplink.busy spans (parallel links)</p>'
    rows = [[f"node {k}", _fmt(s), f"{up['utilization'][k]:.1%}"]
            for k, s in up["top_uplinks"]]
    note = ('<p class="meta">fair-share uplink: sharing is exact within '
            "one push batch; batches queue FIFO behind a busy uplink "
            "(see docs/observability.md)</p>")
    return _table(["sender", "busy s", "utilization"], rows) + note


def _store_section(store: Optional[dict]) -> str:
    if not store or store["hits"] + store["misses"] == 0:
        return '<p class="meta">no store activity in this run</p>'
    return _table(
        ["hits", "misses", "evictions", "hit ratio", "resident",
         "bytes at rest"],
        [[store["hits"], store["misses"], store["evictions"],
          f"{store['hit_ratio']:.1%}", store["resident"],
          store["bytes_at_rest"]]], numeric_from=0)


def _density_section(dens: Optional[dict]) -> str:
    if not dens or not dens["n"]:
        return ""
    body = _table(
        ["rounds", "max |drift|", "final |drift|", "final measured",
         "final target"],
        [[dens["n"], _fmt(dens["max_drift"]), _fmt(dens["final_drift"]),
          _fmt(dens["final_measured"]), _fmt(dens["final_target"])]],
        numeric_from=0)
    return "<h2>density vs anneal schedule</h2>" + body


def _phase_section(ph: dict) -> str:
    if not ph:
        return '<p class="meta">no spans to summarize</p>'
    rows = [[name, d["count"], _fmt(d["total_s"]), _fmt(d["mean_s"], 4),
             _fmt(d["max_s"], 4)]
            for name, d in sorted(ph.items(),
                                  key=lambda kv: -kv[1]["total_s"])]
    return _table(["phase", "count", "total s", "mean s", "max s"], rows)


def _counters_section(counters: dict) -> str:
    if not counters:
        return '<p class="meta">no counters in this archive</p>'
    rows = [[k, _fmt(v)] for k, v in sorted(counters.items())]
    return _table(["counter", "value"], rows)


def _page(title: str, subtitle: str, body: str) -> str:
    # the footer names the reference's module, and the run subtitle its
    # ``jax`` version key: a page is byte-identical whichever package
    # renders it
    return (
        "<!doctype html>\n<html lang=\"en\"><head>"
        '<meta charset="utf-8">'
        '<meta name="viewport" content="width=device-width,initial-scale=1">'
        f"<title>{_esc(title)}</title>"
        f"<style>{_CSS}</style></head><body>"
        f"<h1>{_esc(title)}</h1>"
        f'<p class="sub">{subtitle}</p>'
        f"{body}"
        '<p class="meta">generated by repro.launch.dash — '
        "self-contained, no scripts, no network</p>"
        "</body></html>\n")


def _density_pair(series_doc: dict):
    sd = series_doc.get("series", {})
    m = sd.get("fl.engine/density_measured")
    t = sd.get("fl.engine/density_target")
    if m is None or t is None:
        return None
    return (TimeSeries.from_dict(m), TimeSeries.from_dict(t))


def render_dashboard(archive: Optional[RunArchive] = None,
                     trace_doc: Optional[dict] = None,
                     thresholds: Optional[HealthThresholds] = None) -> str:
    """The dashboard HTML for a run archive, or for a bare trace document
    (whose ``otherData.counters`` snapshot stands in for the archive's
    ``counters.json``; series cards then render empty)."""
    if archive is None and trace_doc is None:
        raise ValueError("need a RunArchive or a trace document")
    manifest = archive.manifest() if archive is not None else None
    if trace_doc is None:
        trace_doc = archive.trace()
    series_doc = archive.series() if archive is not None else {}
    counters = (archive.counters() if archive is not None else
                (trace_doc or {}).get("otherData", {}).get("counters", {}))

    spans = spans_from_trace_doc(trace_doc) if trace_doc else []
    dropped = int((trace_doc or {}).get("otherData", {})
                  .get("droppedSpans", 0))
    roll, events = fleet_health(
        spans, counters=counters, thresholds=thresholds,
        density=_density_pair(series_doc), dropped_spans=dropped)

    if manifest is not None:
        title = f"run {manifest.run_id}"
        sub = (f"{_esc(manifest.kind)} · {_esc(manifest.created_iso)} · "
               f"git {_esc(manifest.git_sha)} · seed "
               f"{_esc(manifest.seed)} · jax "
               f"{_esc(manifest.versions.get('jax', '–'))}")
    else:
        title = "trace dashboard"
        sub = (f"{len(spans)} spans · "
               f"mode {_esc((trace_doc or {}).get('otherData', {}).get('mode', '–'))}")

    body = [
        "<h2>fleet health</h2>", _health_section(events),
        "<h2>communication</h2>", _comm_section(roll["comm"]),
        "<h2>stragglers</h2>", _straggler_section(roll["stragglers"]),
        "<h2>SSP staleness</h2>", _staleness_section(roll["staleness"]),
        "<h2>uplinks</h2>", _uplink_section(roll["uplinks"]),
        "<h2>model store</h2>", _store_section(roll.get("store")),
        _density_section(roll.get("density")),
        "<h2>time series</h2>", _series_cards(series_doc),
        "<h2>latency sketches</h2>", _histogram_table(series_doc),
        "<h2>phases</h2>", _phase_section(phase_summary(spans)),
        "<h2>counters</h2>", _counters_section(counters),
    ]
    return _page(title, sub, "".join(body))


# ---------------------------------------------------------------------------
# diff mode (cross-run regression attribution, rendered)
# ---------------------------------------------------------------------------

def _delta_cell(delta: float, suffix: str = "") -> tuple:
    """Regressed (slower/bigger) vs improved is *state*: status colors
    with an arrow icon + signed number, never color alone."""
    if delta > 0:
        return (f'<span class="delta-up">▲ +{_fmt(delta)}{suffix}'
                "</span>",)
    return (f'<span class="delta-down">▼ {_fmt(delta)}{suffix}'
            "</span>",)


def render_diff(old: dict, new: dict, old_label: str, new_label: str,
                top_k: int = 5) -> str:
    d = diff_runs(old, new, top_k=top_k)
    ph_rows = [[p["phase"], _fmt(p["old_s"]), _fmt(p["new_s"]),
                _delta_cell(p["delta_s"], " s"),
                "inf" if math.isinf(p["ratio"]) else _fmt(p["ratio"], 2)]
               for p in d["phases"]]
    ct_rows = [[c["counter"], _fmt(c["old"]), _fmt(c["new"]),
                _delta_cell(c["delta"]), f"{c['rel']:.1%}"]
               for c in d["counters"]]
    body = [
        "<h2>phase deltas (by |total s|)</h2>",
        _table(["phase", "old s", "new s", "delta", "ratio"], ph_rows)
        if ph_rows else '<p class="meta">no phase deltas</p>',
        "<h2>counter deltas (by relative change)</h2>",
        _table(["counter", "old", "new", "delta", "rel"], ct_rows)
        if ct_rows else '<p class="meta">no counter deltas</p>',
    ]
    return _page("run diff",
                 f"{_esc(old_label)} → {_esc(new_label)}",
                 "".join(body))


def _run_doc_from_archive(ar: RunArchive) -> dict:
    return {"phase_summary": ar.phase_summary(),
            "counters": ar.counters()}


# ---------------------------------------------------------------------------
# --check: validate the artifact + reconcile against counters
# ---------------------------------------------------------------------------

_REQUIRED_SECTIONS = ("fleet health", "communication", "phases", "counters")


def check_dashboard(page: str, trace_doc: Optional[dict],
                    counters: dict) -> list[str]:
    """Structural + reconciliation problems with a rendered dashboard;
    empty list means it passed.  Reconciliation (span-derived byte sums
    vs the ``sim.links`` counters) only applies when the trace is
    complete — a ring buffer that dropped spans under-counts by design
    and is reported on the page instead."""
    problems = []
    if not page.startswith("<!doctype html>"):
        problems.append("not an HTML document")
    if "<script" in page.lower():
        problems.append("dashboard must not contain scripts")
    for sec in _REQUIRED_SECTIONS:
        if f"<h2>{sec}</h2>" not in page:
            problems.append(f"missing section {sec!r}")
    if trace_doc is None:
        return problems
    dropped = int(trace_doc.get("otherData", {}).get("droppedSpans", 0))
    if dropped or "sim.links/bytes_values" not in counters:
        return problems
    from repro_torch.obs import comm_rollup
    comm = comm_rollup(spans_from_trace_doc(trace_doc))
    pairs = [
        ("sim.links/bytes_values", sum(comm["up_bytes"].values())),
        ("sim.links/bytes_wire", sum(comm["up_wire_bytes"].values())),
        ("sim.links/n_retransmits", comm["n_retransmits"]),
        ("sim.links/transfers", comm["n_transfers"]),
    ]
    for key, derived in pairs:
        want = float(counters.get(key, 0.0))
        if float(derived) != want:
            problems.append(
                f"rollup {key} = {derived!r} does not reconcile with "
                f"counter {want!r}")
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dash")
    sub = ap.add_subparsers(dest="mode", required=True)

    r = sub.add_parser("render", help="dashboard from a run dir or trace")
    r.add_argument("--run-dir", default="", dest="run_dir")
    r.add_argument("--trace", default="",
                   help="bare Perfetto trace JSON (when no --run-dir)")
    r.add_argument("-o", "--out", default="dash.html")
    r.add_argument("--check", action="store_true",
                   help="validate the artifact and reconcile rollups "
                        "against counters; nonzero exit on failure")

    d = sub.add_parser("diff", help="cross-run regression attribution")
    d.add_argument("--history", default="",
                   help="BENCH_history.jsonl — diff the two newest runs")
    d.add_argument("--old", default="", help="older run dir")
    d.add_argument("--new", default="", help="newer run dir")
    d.add_argument("-o", "--out", default="diff.html")
    d.add_argument("--top-k", type=int, default=5, dest="top_k")

    args = ap.parse_args(argv)
    if args.mode == "render":
        if not args.run_dir and not args.trace:
            ap.error("render needs --run-dir or --trace")
        archive = trace_doc = None
        if args.run_dir:
            archive = RunArchive(args.run_dir)
            if not archive.exists:
                ap.error(f"{args.run_dir} is not a run archive "
                         "(no manifest.json)")
            trace_doc = archive.trace()
            counters = archive.counters()
        else:
            with open(args.trace) as f:
                trace_doc = json.load(f)
            counters = trace_doc.get("otherData", {}).get("counters", {})
        page = render_dashboard(archive=archive, trace_doc=trace_doc)
        with open(args.out, "w") as f:
            f.write(page)
        print(f"wrote {args.out} ({len(page)} bytes)")
        if args.check:
            problems = check_dashboard(page, trace_doc, counters)
            if problems:
                for p in problems:
                    print(f"CHECK FAIL: {p}")
                return 1
            print("check ok: structure valid, rollups reconcile")
        return 0

    # diff
    if args.history:
        runs = read_history(args.history, event="run")
        if len(runs) < 2:
            ap.error(f"{args.history} has {len(runs)} run lines; "
                     "need >= 2 to diff")
        old, new = runs[-2], runs[-1]
        old_label = f"{old.get('git_sha', '?')} @ {old.get('iso', '?')}"
        new_label = f"{new.get('git_sha', '?')} @ {new.get('iso', '?')}"
    elif args.old and args.new:
        old = _run_doc_from_archive(RunArchive(args.old))
        new = _run_doc_from_archive(RunArchive(args.new))
        old_label, new_label = args.old, args.new
    else:
        ap.error("diff needs --history or both --old and --new")
    page = render_diff(old, new, old_label, new_label, top_k=args.top_k)
    with open(args.out, "w") as f:
        f.write(page)
    print(f"wrote {args.out} ({len(page)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
