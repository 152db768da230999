"""Typed time-series and bounded-memory quantile histograms (obs layer 2;
reference ``repro.obs.series``, copied line for line).

Spans (``obs.trace``) and counters (``obs.counters``) record what
happened.  This module adds the *monitorable* layer on
top: values sampled over time, and value distributions with error-bounded
percentiles — both with hard memory bounds so they can live inside engine
loops for millions of rounds/requests without growing unboundedly.

* ``TimeSeries`` — ``(t, value)`` samples on a declared clock domain
  (``WALL`` or ``VIRTUAL``, same constants as the tracer) and a declared
  kind: ``"gauge"`` (point-in-time readings, e.g. busiest-node MB) or
  ``"counter"`` (cumulative readings of a monotonic counter, e.g. bytes
  on wire — ``deltas()``/``delta_sum()`` recover per-window increments,
  and the telescoping identity ``delta_sum() == last - initial`` is what
  the reconciliation tests pin against ``snapshot_counters()``).  When a
  series exceeds its point budget it decimates to every second sample
  (always keeping the newest); cumulative counter samples survive this
  losslessly in total (telescoping sum), gauges become subsampled.

* ``LogHistogram`` — a DDSketch-style log-bucket sketch: sparse integer
  buckets at geometric boundaries ``gamma^i`` with
  ``gamma = (1+alpha)/(1-alpha)``.  Any reported quantile is within
  relative error ``alpha`` of the exact sample quantile; two sketches
  with the same ``alpha`` merge exactly (bucket-count addition), and
  memory is capped at ``max_buckets`` by collapsing the lowest buckets
  (the DDSketch policy: tail quantiles — the ones dashboards read —
  keep full accuracy).  This replaces the unbounded Python lists that
  previously backed serve wait/service percentiles and link transfer
  times.

* ``SeriesSet`` — a namespaced bundle (one per engine/store, mirroring
  ``CounterSet``) weakly registered process-wide so ``snapshot_series()``
  can archive every live series/histogram as one JSON-serializable doc
  (``repro.obs.runs`` stores that doc in the run archive;
  ``launch/dash.py`` renders sparklines from it).

Importing this module never imports torch or numpy — it is safe in the
hottest engine loops.
"""
from __future__ import annotations

import math
import threading
import weakref
from typing import Optional

from repro_torch.obs.trace import CLOCKS, WALL

GAUGE = "gauge"
COUNTER = "counter"
KINDS = (GAUGE, COUNTER)

#: schema version for the series snapshot doc stored in run archives
SERIES_SCHEMA_VERSION = 1

DEFAULT_MAX_POINTS = 4096
DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BUCKETS = 1024


class TimeSeries:
    """Bounded ``(t, value)`` samples on one clock, gauge- or counter-kind."""

    __slots__ = ("name", "clock", "kind", "max_points", "initial", "_pts")

    def __init__(self, name: str, clock: str = WALL, kind: str = GAUGE,
                 max_points: int = DEFAULT_MAX_POINTS, initial: float = 0.0):
        if clock not in CLOCKS:
            raise ValueError(f"clock must be one of {CLOCKS}, got {clock!r}")
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if max_points < 2:
            raise ValueError("max_points must be >= 2")
        self.name = name
        self.clock = clock
        self.kind = kind
        self.max_points = int(max_points)
        #: baseline for counter-kind deltas (value before the first sample)
        self.initial = float(initial)
        self._pts: list[tuple[float, float]] = []

    def observe(self, t: float, value: float) -> None:
        """Record one sample.  Counter-kind series record the *cumulative*
        counter value (not the increment)."""
        self._pts.append((float(t), float(value)))
        if len(self._pts) > self.max_points:
            # decimate to every 2nd sample, always keeping the newest:
            # for cumulative counter samples the telescoping delta sum is
            # unchanged; gauges become half-rate subsampled.
            last = self._pts[-1]
            kept = self._pts[:-1:2]
            if kept and kept[-1] == last:
                self._pts = kept
            else:
                kept.append(last)
                self._pts = kept

    def __len__(self) -> int:
        return len(self._pts)

    def points(self) -> list[tuple[float, float]]:
        return list(self._pts)

    @property
    def last(self) -> Optional[tuple[float, float]]:
        return self._pts[-1] if self._pts else None

    def deltas(self) -> list[tuple[float, float]]:
        """Per-window increments of a counter-kind series (first window is
        relative to ``initial``)."""
        if self.kind != COUNTER:
            raise TypeError(f"series {self.name!r} is a gauge; no deltas")
        out, prev = [], self.initial
        for t, v in self._pts:
            out.append((t, v - prev))
            prev = v
        return out

    def delta_sum(self) -> float:
        """Telescoping sum of ``deltas()`` — exactly ``last - initial``
        regardless of decimation (the reconciliation invariant)."""
        if self.kind != COUNTER:
            raise TypeError(f"series {self.name!r} is a gauge; no deltas")
        if not self._pts:
            return 0.0
        return self._pts[-1][1] - self.initial

    def to_dict(self) -> dict:
        return {"name": self.name, "clock": self.clock, "kind": self.kind,
                "initial": self.initial,
                "points": [[t, v] for t, v in self._pts]}

    @classmethod
    def from_dict(cls, d: dict) -> "TimeSeries":
        ts = cls(d["name"], clock=d["clock"], kind=d["kind"],
                 initial=float(d.get("initial", 0.0)))
        ts._pts = [(float(t), float(v)) for t, v in d["points"]]
        return ts


class LogHistogram:
    """DDSketch-style mergeable histogram with ``alpha``-bounded quantiles.

    Buckets sit at geometric boundaries ``gamma^(i-1) < x <= gamma^i``
    with ``gamma = (1+alpha)/(1-alpha)``; a bucket's representative value
    is the midpoint ``2*gamma^i/(gamma+1)``, which is within relative
    error ``alpha`` of every sample in the bucket.  Values must be
    >= 0 (durations, byte counts); exact zeros get their own bucket.

    Memory is bounded: at most ``max_buckets`` non-zero buckets, enforced
    by collapsing the *lowest* pair when exceeded (tail quantiles keep
    the full guarantee; only quantiles that land in collapsed low buckets
    degrade, and only downward in resolution, never in ordering).  With
    the defaults (alpha=0.01, 1024 buckets) the sketch covers ~9 decades
    before any collapse — far more dynamic range than any duration or
    byte-size distribution here produces, so in practice quantiles stay
    within ``alpha`` everywhere.
    """

    __slots__ = ("alpha", "max_buckets", "gamma", "_log_gamma", "_counts",
                 "zero_count", "count", "sum", "min", "max", "collapsed")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_buckets < 2:
            raise ValueError("max_buckets must be >= 2")
        self.alpha = float(alpha)
        self.max_buckets = int(max_buckets)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self._counts: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        #: number of low-bucket collapses performed (0 == exact-α sketch)
        self.collapsed = 0

    def _index(self, x: float) -> int:
        return int(math.ceil(math.log(x) / self._log_gamma))

    def _value(self, i: int) -> float:
        return 2.0 * math.pow(self.gamma, i) / (self.gamma + 1.0)

    def add(self, x: float, n: int = 1) -> None:
        x = float(x)
        if x < 0.0:
            raise ValueError(f"LogHistogram values must be >= 0, got {x}")
        if n < 1:
            raise ValueError("n must be >= 1")
        self.count += n
        self.sum += x * n
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        if x == 0.0:
            self.zero_count += n
            return
        i = self._index(x)
        self._counts[i] = self._counts.get(i, 0) + n
        if len(self._counts) > self.max_buckets:
            self._collapse_lowest()

    def _collapse_lowest(self) -> None:
        lows = sorted(self._counts)[:2]
        lo, nxt = lows[0], lows[1]
        self._counts[nxt] += self._counts.pop(lo)
        self.collapsed += 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """In-place exact merge (same ``alpha`` required); returns self."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} and "
                f"{other.alpha}")
        for i, n in other._counts.items():
            self._counts[i] = self._counts.get(i, 0) + n
        while len(self._counts) > self.max_buckets:
            self._collapse_lowest()
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.collapsed += other.collapsed
        return self

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def n_buckets(self) -> int:
        return len(self._counts) + (1 if self.zero_count else 0)

    def quantile(self, q: float) -> float:
        """Sample quantile within relative error ``alpha`` (nearest-rank
        over buckets).  Returns 0.0 on an empty sketch."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = self.zero_count
        if rank < seen:
            return 0.0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if rank < seen:
                return self._value(i)
        return self._value(max(self._counts))    # pragma: no cover

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    def to_dict(self) -> dict:
        return {"alpha": self.alpha, "max_buckets": self.max_buckets,
                "counts": {str(i): n for i, n in sorted(self._counts.items())},
                "zero_count": self.zero_count, "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "collapsed": self.collapsed}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(alpha=float(d["alpha"]),
                max_buckets=int(d.get("max_buckets", DEFAULT_MAX_BUCKETS)))
        h._counts = {int(i): int(n) for i, n in d["counts"].items()}
        h.zero_count = int(d.get("zero_count", 0))
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        h.collapsed = int(d.get("collapsed", 0))
        return h


_REGISTRY: "weakref.WeakSet[SeriesSet]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


class SeriesSet:
    """A namespaced bundle of series/histograms, weakly registered
    process-wide (the owner holds the only strong reference, mirroring
    ``CounterSet`` semantics)."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._series: dict[str, TimeSeries] = {}
        self._hists: dict[str, LogHistogram] = {}
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)

    def series(self, name: str, clock: str = WALL, kind: str = GAUGE,
               max_points: int = DEFAULT_MAX_POINTS,
               initial: float = 0.0) -> TimeSeries:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = TimeSeries(
                name, clock=clock, kind=kind, max_points=max_points,
                initial=initial)
        return s

    def histogram(self, name: str, alpha: float = DEFAULT_ALPHA,
                  max_buckets: int = DEFAULT_MAX_BUCKETS) -> LogHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = LogHistogram(alpha=alpha,
                                                max_buckets=max_buckets)
        return h

    def snapshot(self) -> dict:
        """JSON-serializable doc of every series and histogram."""
        return {
            "series": {n: s.to_dict()
                       for n, s in sorted(self._series.items())},
            "histograms": {n: h.to_dict()
                           for n, h in sorted(self._hists.items())},
        }


def snapshot_series(prefix: Optional[str] = None) -> dict:
    """Archive doc over every live ``SeriesSet``: versioned, with flat
    ``namespace/name`` keys (the run-archive ``series.json`` payload)."""
    with _REGISTRY_LOCK:
        sets = list(_REGISTRY)
    series: dict[str, dict] = {}
    hists: dict[str, dict] = {}
    for ss in sorted(sets, key=lambda s: s.namespace):
        if prefix is not None and not ss.namespace.startswith(prefix):
            continue
        snap = ss.snapshot()
        for name, doc in snap["series"].items():
            series[f"{ss.namespace}/{name}"] = doc
        for name, doc in snap["histograms"].items():
            hists[f"{ss.namespace}/{name}"] = doc
    return {"seriesSchemaVersion": SERIES_SCHEMA_VERSION,
            "series": series, "histograms": hists}
