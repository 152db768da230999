"""Simulation reporting: deployment-facing numbers from measured transfers
(reference ``repro.sim.report``).

``build_report`` turns a run's ``LinkStats`` + accuracy trace into virtual
wall-clock to a target accuracy, the busiest node's upload/download
timeline, per-link utilization and total measured bytes-on-wire
(``SimReport``, ``time_to_target`` and ``build_report`` are copied line for
line).  ``MetricsStream`` is the JSON-lines emitter the serving CLI
streams through and run archives write their health events with, one JSON
object per line, without the reference's ``append`` option, which no port
caller uses.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import IO, Optional, Sequence

from repro_torch.sim.links import MB, LinkStats


class MetricsStream:
    """Append one JSON object per line to a file or stdout, flushing each
    line so consumers see metrics live.

    ``header=True`` prefixes the stream with one ``{"event": "schema",
    "version": N}`` record (the JSONL schema version lives in
    ``obs.export``).  ``close`` only closes handles this stream opened —
    never stdout, even if ``sys.stdout`` was rebound between open and
    close — and the stream is a context manager."""

    def __init__(self, path: str = "-", header: bool = False):
        self.path = path
        self.header = bool(header)
        self._fh: Optional[IO] = None
        self._closes = False          # True iff we opened (and must close) it
        self._header_written = False

    def _handle(self) -> IO:
        if self._fh is None:
            if self.path in ("-", ""):
                self._fh = sys.stdout
                self._closes = False
            else:
                import os
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "w")
                self._closes = True
        return self._fh

    def emit(self, record: dict) -> None:
        fh = self._handle()
        if self.header and not self._header_written:
            self._header_written = True
            from repro_torch.obs import JSONL_SCHEMA_VERSION
            fh.write(json.dumps({"event": "schema",
                                 "version": JSONL_SCHEMA_VERSION}) + "\n")
        fh.write(json.dumps(record) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None and self._closes:
            self._fh.close()
        self._fh = None
        self._closes = False

    def __enter__(self) -> "MetricsStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class SimReport:
    mode: str
    sim_wall_s: float                       # total virtual seconds
    total_mb: float                         # measured, value-bytes
    total_wire_mb: float                    # + mask bitmaps
    retrans_mb: float                       # value-MB spent on retransmits
    n_retransmits: int                      # retransmitted attempts
    lost_messages: int                      # never delivered (async loss)
    busiest_node: int
    busiest_node_mb: float                  # max(up, down) convention
    busiest_up_mb: float
    busiest_down_mb: float
    time_to_target_s: dict                  # target acc -> virtual s (or -1)
    busiest_mb_at_target: dict              # target acc -> busiest-node MB
    link_utilization_mean: float            # over used edges
    link_utilization_max: float
    n_transfers: int
    acc_trace: list                         # [(virtual s, acc), ...]
    busiest_timeline: list                  # [(virtual s, up MB, down MB), ...]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["acc_trace"] = [(round(t, 3), round(a, 4)) for t, a in self.acc_trace]
        d["busiest_timeline"] = [
            (round(t, 3), round(u, 3), round(dn, 3))
            for t, u, dn in self.busiest_timeline]
        return d

    def row(self) -> dict:
        """Compact benchmark row (no timelines)."""
        return {
            "mode": self.mode,
            "sim_wall_s": round(self.sim_wall_s, 2),
            "busiest_MB": round(self.busiest_node_mb, 2),
            "total_MB": round(self.total_mb, 2),
            "retrans_MB": round(self.retrans_mb, 3),
            "lost_messages": self.lost_messages,
            "time_to_target_s": {str(k): round(v, 2)
                                 for k, v in self.time_to_target_s.items()},
            "busiest_MB_at_target": {str(k): round(v, 2)
                                     for k, v in self.busiest_mb_at_target.items()},
            "link_util_mean": round(self.link_utilization_mean, 4),
        }


def time_to_target(acc_trace: Sequence[tuple[float, float]],
                   target: float) -> float:
    """First virtual time the accuracy trace reaches ``target`` (-1: never)."""
    for t, acc in acc_trace:
        if acc >= target:
            return float(t)
    return -1.0


def build_report(mode: str, stats: LinkStats,
                 acc_trace: Sequence[tuple[float, float]],
                 sim_wall_s: float,
                 targets: Sequence[float] = ()) -> SimReport:
    node, busiest_mb = stats.busiest_node()
    util = stats.utilization(sim_wall_s)
    used = util[stats.edge_bytes > 0]
    ttt, mb_at = {}, {}
    for tgt in targets:
        t_hit = time_to_target(acc_trace, tgt)
        ttt[tgt] = t_hit
        mb_at[tgt] = stats.busiest_mb_until(t_hit) if t_hit >= 0 else -1.0
    return SimReport(
        mode=mode,
        sim_wall_s=float(sim_wall_s),
        total_mb=stats.total_mb,
        total_wire_mb=stats.total_wire_mb,
        retrans_mb=stats.retrans_mb,
        n_retransmits=stats.n_retransmits,
        lost_messages=stats.n_lost,
        busiest_node=node,
        busiest_node_mb=busiest_mb,
        busiest_up_mb=float(stats.up[node]) * MB,
        busiest_down_mb=float(stats.down[node]) * MB,
        time_to_target_s=ttt,
        busiest_mb_at_target=mb_at,
        link_utilization_mean=float(used.mean()) if used.size else 0.0,
        link_utilization_max=float(used.max()) if used.size else 0.0,
        n_transfers=len(stats.transfers),
        acc_trace=list(acc_trace),
        busiest_timeline=stats.node_timeline(node))
