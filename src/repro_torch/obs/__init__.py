"""Tracing spans, counters and bounded-memory series (reference
``repro.obs``: its ``trace``, ``counters`` and ``series`` modules).

The serving plane records its launch phases as spans, its cache counters
in a ``CounterSet`` and its latency quantiles in ``LogHistogram`` sketches.
The reference's export, health, run-archive and dashboard layers are not
ported yet.  Importing this package imports neither torch nor numpy.
"""
from repro_torch.obs.counters import (
    Counter,
    CounterSet,
    Gauge,
    snapshot_counters,
)
from repro_torch.obs.series import (
    LogHistogram,
    SeriesSet,
    TimeSeries,
    snapshot_series,
)
from repro_torch.obs.trace import (
    CLOCKS,
    VIRTUAL,
    WALL,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    span,
)

__all__ = [
    "CLOCKS",
    "Counter",
    "CounterSet",
    "Gauge",
    "LogHistogram",
    "SeriesSet",
    "Span",
    "TimeSeries",
    "Tracer",
    "VIRTUAL",
    "WALL",
    "get_tracer",
    "set_tracer",
    "snapshot_counters",
    "snapshot_series",
    "span",
]
