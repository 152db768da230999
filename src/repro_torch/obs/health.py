"""Fleet-health rollups and threshold events (obs layer 2; reference
``repro.obs.health``, copied line for line).

Turns the spans and counters the engines emit into the aggregates an
operator watches: which node is busiest and by how much, which clients
straggle, which links retransmit, how stale the SSP waits run, whether the
store is hitting, and whether measured sparsity is tracking the anneal
schedule.  Everything here is *derived* — rollups are pure functions of
spans + counters, so they compute identically from a live ``Tracer``, a
list of ``Span`` objects, or a trace document loaded back from disk
(``obs.export.spans_from_trace_doc``), which is what lets
``launch/dash.py`` render from a run archive and lets tests reconcile
rollups against ``LinkStats`` exactly.

Exactness contract: the sim engine's ``_trace_xfer`` mirrors each
``LinkStats.record`` with the same floats in the same order, so
``comm_rollup`` over a *complete* span buffer (``mode="full"``, or ring
with zero drops) reproduces ``LinkStats``' per-node byte accumulators
bit-for-bit — the additions happen in the same sequence.  A ring buffer
that dropped spans under-counts; ``fleet_health`` surfaces that as a
``trace.dropped`` health event rather than silently reconciling wrong.

``HealthThresholds`` + ``fleet_health`` produce ``HealthEvent`` rows
(severity ``warning | serious | critical``, one per tripped rule) which
``emit_health`` streams as ``{"event": "health", ...}`` records through
``sim.report.MetricsStream``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.obs.series import LogHistogram, TimeSeries
from repro_torch.obs.trace import VIRTUAL, Span, Tracer

MB = 1e-6   # decimal MB, matching sim.links / the paper's tables

SEVERITIES = ("warning", "serious", "critical")


def _spans_of(source) -> list[Span]:
    """Normalize a rollup source: Tracer | Sequence[Span] | trace doc."""
    if isinstance(source, Tracer):
        return source.spans()
    if isinstance(source, dict):
        from repro_torch.obs.export import spans_from_trace_doc
        return spans_from_trace_doc(source)
    return list(source)


# ---------------------------------------------------------------------------
# rollups (pure functions of spans/counters)
# ---------------------------------------------------------------------------

def comm_rollup(source, top_k: int = 5) -> dict:
    """Per-node traffic and per-link retransmit rates from the virtual
    ``transfer``/``retransmit`` spans.

    Byte sums reconcile exactly with ``LinkStats`` (same floats, same
    addition order) when the span buffer is complete.  ``per_node_mb``
    follows the paper's busiest-direction convention ``max(up, down)``.
    """
    up: dict[int, float] = {}
    down: dict[int, float] = {}
    up_wire: dict[int, float] = {}
    down_wire: dict[int, float] = {}
    link_attempts: dict[tuple[int, int], int] = {}
    link_retrans: dict[tuple[int, int], int] = {}
    retrans_bytes = 0.0
    n_transfers = 0
    xfer_s = LogHistogram()
    for s in _spans_of(source):
        if s.name not in ("transfer", "retransmit") or s.clock != VIRTUAL:
            continue
        src, dst = int(s.attrs["src"]), int(s.attrs["dst"])
        bv = float(s.attrs["bytes_values"])
        bw = float(s.attrs["bytes_wire"])
        up[src] = up.get(src, 0.0) + bv
        down[dst] = down.get(dst, 0.0) + bv
        up_wire[src] = up_wire.get(src, 0.0) + bw
        down_wire[dst] = down_wire.get(dst, 0.0) + bw
        link_attempts[(src, dst)] = link_attempts.get((src, dst), 0) + 1
        if int(s.attrs.get("attempt", 0)) > 0:
            link_retrans[(src, dst)] = link_retrans.get((src, dst), 0) + 1
            retrans_bytes += bv
        n_transfers += 1
        xfer_s.add(max(s.dur, 0.0))
    nodes = sorted(set(up) | set(down))
    per_node_mb = {k: max(up.get(k, 0.0), down.get(k, 0.0)) * MB
                   for k in nodes}
    busiest = max(per_node_mb, key=per_node_mb.get) if per_node_mb else None
    total_retrans = sum(link_retrans.values())
    link_rates = {f"{s}->{d}": link_retrans.get((s, d), 0) / n
                  for (s, d), n in sorted(link_attempts.items())}
    return {
        "n_transfers": n_transfers,
        "nodes": nodes,
        "up_bytes": {k: up.get(k, 0.0) for k in nodes},
        "down_bytes": {k: down.get(k, 0.0) for k in nodes},
        "up_wire_bytes": {k: up_wire.get(k, 0.0) for k in nodes},
        "down_wire_bytes": {k: down_wire.get(k, 0.0) for k in nodes},
        "per_node_mb": per_node_mb,
        "busiest_node": busiest,
        "busiest_node_mb": per_node_mb.get(busiest, 0.0) if nodes else 0.0,
        "mean_node_mb": (sum(per_node_mb.values()) / len(nodes)
                         if nodes else 0.0),
        "top_nodes": sorted(per_node_mb.items(), key=lambda kv: -kv[1])[:top_k],
        "total_mb": sum(up.values()) * MB,
        "retrans_mb": retrans_bytes * MB,
        "n_retransmits": total_retrans,
        "retransmit_rate": (total_retrans / n_transfers
                            if n_transfers else 0.0),
        "link_retransmit_rate": link_rates,
        "worst_links": sorted(link_rates.items(),
                              key=lambda kv: -kv[1])[:top_k],
        "transfer_s": xfer_s,
    }


def straggler_rollup(source, top_k: int = 5) -> dict:
    """Per-client compute totals from the virtual ``compute`` spans on
    ``client/*`` tracks; ``top_stragglers`` are the largest totals."""
    totals: dict[int, float] = {}
    counts: dict[int, int] = {}
    hist = LogHistogram()
    for s in _spans_of(source):
        if s.name != "compute" or not s.track.startswith("client/"):
            continue
        k = int(s.track.split("/", 1)[1])
        d = max(s.dur, 0.0)
        totals[k] = totals.get(k, 0.0) + d
        counts[k] = counts.get(k, 0) + 1
        hist.add(d)
    mean = (sum(totals.values()) / len(totals)) if totals else 0.0
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:top_k]
    return {
        "n_clients": len(totals),
        "compute_s": totals,
        "spans_per_client": counts,
        "mean_compute_s": mean,
        "top_stragglers": top,
        "straggler_ratio": (top[0][1] / mean if top and mean > 0 else 0.0),
        "compute_span_s": hist,
    }


def staleness_rollup(source) -> dict:
    """SSP wait distribution from the virtual ``ssp.wait`` spans."""
    hist = LogHistogram()
    per_client: dict[int, float] = {}
    for s in _spans_of(source):
        if s.name != "ssp.wait":
            continue
        k = int(s.track.split("/", 1)[1]) if "/" in s.track else -1
        d = max(s.dur, 0.0)
        hist.add(d)
        per_client[k] = per_client.get(k, 0.0) + d
    return {"n_waits": hist.count, "total_wait_s": hist.sum,
            "wait_s": hist, "per_client_wait_s": per_client,
            "p99_wait_s": hist.quantile(0.99)}


def uplink_rollup(source, top_k: int = 5) -> dict:
    """Per-sender uplink busy seconds from the ``uplink.busy`` spans.

    Approximation caveat (documented in ``docs/observability.md``): under
    the ``fair`` discipline sharing is exact *within* one push batch, but
    batches queue FIFO behind a busy uplink, so busy seconds here are the
    serialized occupancy of that hybrid schedule — not an idealized
    processor-sharing fluid limit across batches.
    """
    busy: dict[int, float] = {}
    t_max = 0.0
    for s in _spans_of(source):
        if s.name != "uplink.busy":
            continue
        src = int(s.track.split("/", 1)[1])
        busy[src] = busy.get(src, 0.0) + max(s.dur, 0.0)
        t_max = max(t_max, s.t1)
    util = {k: (v / t_max if t_max > 0 else 0.0) for k, v in busy.items()}
    return {"busy_s": busy, "span_s": t_max, "utilization": util,
            "top_uplinks": sorted(busy.items(), key=lambda kv: -kv[1])[:top_k]}


def store_rollup(counters: dict) -> dict:
    """Hit ratio and occupancy from a ``snapshot_counters()`` dict."""
    hits = float(counters.get("serve.store/hits", 0))
    misses = float(counters.get("serve.store/misses", 0))
    return {
        "hits": hits,
        "misses": misses,
        "evictions": float(counters.get("serve.store/evictions", 0)),
        "resident": float(counters.get("serve.store/resident", 0)),
        "bytes_at_rest": float(counters.get("serve.store/bytes_at_rest", 0)),
        "hit_ratio": hits / max(hits + misses, 1.0),
    }


def density_drift(measured: TimeSeries, target: TimeSeries) -> dict:
    """Measured-density-vs-anneal-schedule drift: pair the two gauge
    series positionally (both are sampled once per round by the engine)
    and report the largest and final absolute drift."""
    pts_m, pts_t = measured.points(), target.points()
    n = min(len(pts_m), len(pts_t))
    drifts = [abs(pts_m[i][1] - pts_t[i][1]) for i in range(n)]
    return {
        "n": n,
        "max_drift": max(drifts) if drifts else 0.0,
        "final_drift": drifts[-1] if drifts else 0.0,
        "final_measured": pts_m[n - 1][1] if n else None,
        "final_target": pts_t[n - 1][1] if n else None,
    }


# ---------------------------------------------------------------------------
# threshold events
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HealthEvent:
    kind: str            # e.g. "link.retransmit_rate"
    severity: str        # warning | serious | critical
    message: str
    value: float
    threshold: float

    def to_dict(self) -> dict:
        return {"event": "health", "kind": self.kind,
                "severity": self.severity, "message": self.message,
                "value": self.value, "threshold": self.threshold}


@dataclasses.dataclass
class HealthThresholds:
    """Tripwires for ``fleet_health``; ``None`` disables a rule."""
    max_retransmit_rate: Optional[float] = 0.05
    max_busiest_imbalance: Optional[float] = 3.0   # busiest / mean node MB
    max_straggler_ratio: Optional[float] = 3.0     # slowest / mean compute
    max_p99_staleness_s: Optional[float] = None    # run-scale dependent
    min_store_hit_ratio: Optional[float] = 0.5
    max_density_drift: Optional[float] = 0.05      # absolute density units


def _event(events: list, kind: str, severity: str, msg: str,
           value: float, threshold: float) -> None:
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")
    events.append(HealthEvent(kind, severity, msg, float(value),
                              float(threshold)))


def fleet_health(source, counters: Optional[dict] = None,
                 thresholds: Optional[HealthThresholds] = None,
                 density: Optional[tuple[TimeSeries, TimeSeries]] = None,
                 dropped_spans: int = 0) -> tuple[dict, list[HealthEvent]]:
    """Compute every rollup and evaluate the thresholds.

    Returns ``(rollups, events)``; ``rollups`` maps
    ``comm | stragglers | staleness | uplinks | store | density`` to the
    corresponding rollup dict (``store`` only when ``counters`` given,
    ``density`` only when the series pair is given).
    """
    th = thresholds or HealthThresholds()
    spans = _spans_of(source)
    roll = {
        "comm": comm_rollup(spans),
        "stragglers": straggler_rollup(spans),
        "staleness": staleness_rollup(spans),
        "uplinks": uplink_rollup(spans),
    }
    if counters is not None:
        roll["store"] = store_rollup(counters)
    if density is not None:
        roll["density"] = density_drift(*density)

    events: list[HealthEvent] = []
    if dropped_spans:
        _event(events, "trace.dropped", "warning",
               f"{dropped_spans} spans dropped by the ring buffer; "
               "rollups under-count (use --trace-mode full to reconcile)",
               dropped_spans, 0)

    comm = roll["comm"]
    if (th.max_retransmit_rate is not None and comm["n_transfers"]
            and comm["retransmit_rate"] > th.max_retransmit_rate):
        worst = comm["worst_links"][0] if comm["worst_links"] else ("-", 0.0)
        _event(events, "link.retransmit_rate",
               "critical" if comm["retransmit_rate"]
               > 2 * th.max_retransmit_rate else "serious",
               f"fleet retransmit rate {comm['retransmit_rate']:.1%} "
               f"(worst link {worst[0]} at {worst[1]:.1%})",
               comm["retransmit_rate"], th.max_retransmit_rate)
    if (th.max_busiest_imbalance is not None and comm["mean_node_mb"] > 0):
        imb = comm["busiest_node_mb"] / comm["mean_node_mb"]
        if imb > th.max_busiest_imbalance:
            _event(events, "comm.busiest_imbalance", "warning",
                   f"node {comm['busiest_node']} carries {imb:.1f}x the "
                   f"mean per-node traffic "
                   f"({comm['busiest_node_mb']:.2f} MB)",
                   imb, th.max_busiest_imbalance)

    strag = roll["stragglers"]
    if (th.max_straggler_ratio is not None
            and strag["straggler_ratio"] > th.max_straggler_ratio):
        k, total = strag["top_stragglers"][0]
        _event(events, "compute.straggler", "warning",
               f"client {k} spent {total:.2f}s computing, "
               f"{strag['straggler_ratio']:.1f}x the fleet mean",
               strag["straggler_ratio"], th.max_straggler_ratio)

    stale = roll["staleness"]
    if (th.max_p99_staleness_s is not None and stale["n_waits"]
            and stale["p99_wait_s"] > th.max_p99_staleness_s):
        _event(events, "ssp.staleness", "serious",
               f"p99 SSP wait {stale['p99_wait_s']:.2f}s exceeds "
               f"{th.max_p99_staleness_s:.2f}s",
               stale["p99_wait_s"], th.max_p99_staleness_s)

    store = roll.get("store")
    if (store is not None and th.min_store_hit_ratio is not None
            and store["hits"] + store["misses"] > 0
            and store["hit_ratio"] < th.min_store_hit_ratio):
        _event(events, "store.hit_ratio", "warning",
               f"store hit ratio {store['hit_ratio']:.1%} below "
               f"{th.min_store_hit_ratio:.0%}",
               store["hit_ratio"], th.min_store_hit_ratio)

    dens = roll.get("density")
    if (dens is not None and th.max_density_drift is not None
            and dens["max_drift"] > th.max_density_drift):
        _event(events, "density.drift", "serious",
               f"measured density drifted {dens['max_drift']:.3f} from the "
               f"anneal schedule (final measured "
               f"{dens['final_measured']:.3f} vs target "
               f"{dens['final_target']:.3f})",
               dens["max_drift"], th.max_density_drift)

    return roll, events


def emit_health(stream, events: Sequence[HealthEvent]) -> None:
    """Stream health events as JSONL records through a ``MetricsStream``
    (or anything with ``emit(dict)``)."""
    for ev in events:
        stream.emit(ev.to_dict())
