"""The observability plane (reference ``repro.obs``): tracing, counters,
series, export, fleet health and run archives.

One layer shared by the port's engines (``fl.engine``, ``sim``, ``scale``,
``serve``) and the sparse codec:

* ``trace``    — nestable ``span("phase", **attrs)`` on named tracks,
  wall- and virtual-clock, ring-buffered, near-zero cost when disabled;
* ``counters`` — monotonic counters / gauges in namespaced ``CounterSet``
  bundles with a process-wide snapshot, plus the ``torch`` set of kernel
  builds and ``torch.compile`` graphs (``install_torch_hooks``);
* ``series``   — bounded-memory time series and ``LogHistogram`` sketches;
* ``export``   — Chrome/Perfetto ``trace_event`` JSON export and the
  streaming JSONL schema version;
* ``health``   — fleet rollups and threshold events derived from spans and
  counters;
* ``runs``     — run manifests, run archives and the history log.

The documents and archives are the reference's, schema versions included:
a trace or run archive written by either package validates and renders in
the other (``launch/dash.py``); the compile counters are ``torch/*`` here
where the reference's are ``jax/*``.  Importing this package imports
neither torch nor numpy.
"""
from repro_torch.obs.counters import (
    Counter,
    CounterSet,
    Gauge,
    install_torch_hooks,
    snapshot_counters,
    torch_compile_count,
)
from repro_torch.obs.export import (
    JSONL_SCHEMA_VERSION,
    TRACE_SCHEMA_VERSION,
    phase_summary,
    spans_from_trace_doc,
    to_trace_events,
    validate_trace,
    write_trace,
)
from repro_torch.obs.health import (
    HealthEvent,
    HealthThresholds,
    comm_rollup,
    density_drift,
    emit_health,
    fleet_health,
    staleness_rollup,
    store_rollup,
    straggler_rollup,
    uplink_rollup,
)
from repro_torch.obs.runs import (
    RunArchive,
    RunManifest,
    RunRegistry,
    append_history,
    diff_runs,
    git_sha,
    metric_history,
    read_history,
    save_run,
)
from repro_torch.obs.series import (
    SERIES_SCHEMA_VERSION,
    LogHistogram,
    SeriesSet,
    TimeSeries,
    snapshot_series,
)
from repro_torch.obs.trace import (
    VIRTUAL,
    WALL,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    span,
    traced,
)

__all__ = [
    "Counter",
    "CounterSet",
    "Gauge",
    "HealthEvent",
    "HealthThresholds",
    "JSONL_SCHEMA_VERSION",
    "LogHistogram",
    "RunArchive",
    "RunManifest",
    "RunRegistry",
    "SERIES_SCHEMA_VERSION",
    "SeriesSet",
    "Span",
    "TRACE_SCHEMA_VERSION",
    "TimeSeries",
    "Tracer",
    "VIRTUAL",
    "WALL",
    "append_history",
    "comm_rollup",
    "density_drift",
    "diff_runs",
    "emit_health",
    "fleet_health",
    "get_tracer",
    "git_sha",
    "install_torch_hooks",
    "metric_history",
    "phase_summary",
    "read_history",
    "save_run",
    "set_tracer",
    "snapshot_counters",
    "snapshot_series",
    "span",
    "spans_from_trace_doc",
    "staleness_rollup",
    "store_rollup",
    "straggler_rollup",
    "to_trace_events",
    "torch_compile_count",
    "traced",
    "uplink_rollup",
    "validate_trace",
    "write_trace",
]
