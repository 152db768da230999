"""Nestable span tracing on named tracks, wall- and virtual-clock
(reference ``repro.obs.trace``, copied line for line).

One ``Tracer`` records ``Span`` intervals into a bounded ring buffer (or an
unbounded list in ``mode="full"``).  Spans carry a *clock domain*: ``WALL``
spans are measured with ``time.perf_counter`` relative to the tracer's
enable epoch; ``VIRTUAL`` spans are stamped by the caller with simulator
seconds (``repro.sim``'s ``VirtualClock`` timeline, ``repro.serve``'s
request arrivals).  The two domains export as separate Perfetto processes
(``repro.obs.export``) so a run renders as per-client / per-link /
per-slot timelines next to the host's measured phase timings.

Overhead contract: when the tracer is disabled, ``span(...)`` returns a
shared no-op context manager — one attribute check and no allocation on
the hot path — so instrumentation can live permanently in engine loops
(``benchmarks/engine_vmap.py`` gates the enabled-mode ratio, and
``tests/test_obs.py`` smokes the disabled call cost).

The module-level ``span`` / ``get_tracer`` operate on a process default
tracer; ``set_tracer`` swaps it (benchmarks use a private instance so an
overhead probe never clobbers a run-level ``--trace`` capture).
"""
from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

WALL = "wall"
VIRTUAL = "virtual"
CLOCKS = (WALL, VIRTUAL)
MODES = ("ring", "full")
DEFAULT_CAPACITY = 65536


class Span:
    """One closed interval on a named track."""

    __slots__ = ("name", "track", "t0", "t1", "clock", "seq", "attrs")

    def __init__(self, name: str, track: str, t0: float, t1: float,
                 clock: str, seq: int, attrs: dict):
        self.name = name
        self.track = track
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.clock = clock
        self.seq = seq
        self.attrs = attrs

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "track": self.track, "t0": self.t0,
                "t1": self.t1, "clock": self.clock, "seq": self.seq,
                "attrs": dict(self.attrs)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, track={self.track!r}, "
                f"t0={self.t0:.6f}, t1={self.t1:.6f}, clock={self.clock})")


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def attrs(self) -> dict:
        # a fresh throwaway dict: callers may annotate unconditionally
        return {}


_NULL = _NullSpan()


class _SpanCM:
    """Live wall-clock span context manager; ``attrs`` is mutable until
    ``__exit__`` so callers can annotate results computed inside."""

    __slots__ = ("_tracer", "name", "track", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self):
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        t._append(self.name, self.track, self._t0, t.now(), WALL, self.attrs)
        return False


class _OpenSpan:
    """Handle for a begin()/end() span (slot residency, SSP waits)."""

    __slots__ = ("name", "track", "t0", "clock", "attrs")

    def __init__(self, name: str, track: str, t0: float, clock: str,
                 attrs: dict):
        self.name = name
        self.track = track
        self.t0 = float(t0)
        self.clock = clock
        self.attrs = attrs


class Tracer:
    def __init__(self, mode: str = "ring",
                 capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.mode = mode
        self.capacity = int(capacity)
        self.dropped = 0
        self._seq = 0
        self._epoch = 0.0
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._open: dict[int, _OpenSpan] = {}

    # -- lifecycle ---------------------------------------------------------
    def enable(self, mode: Optional[str] = None,
               capacity: Optional[int] = None) -> "Tracer":
        """(Re)arm recording with an empty buffer; the wall epoch resets so
        exported wall timestamps are run-relative."""
        if mode is not None:
            if mode not in MODES:
                raise ValueError(f"trace mode must be one of {MODES}, "
                                 f"got {mode!r}")
            self.mode = mode
        if capacity is not None:
            if capacity < 1:
                raise ValueError("trace capacity must be >= 1")
            self.capacity = int(capacity)
        with self._lock:
            self._spans = deque(
                maxlen=self.capacity if self.mode == "ring" else None)
            self._open = {}
            self.dropped = 0
            self._seq = 0
            self._epoch = time.perf_counter()
            self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open = {}
            self.dropped = 0
            self._seq = 0

    def now(self) -> float:
        """Wall seconds since the enable epoch."""
        return time.perf_counter() - self._epoch

    def __len__(self) -> int:
        return len(self._spans)

    # -- recording ---------------------------------------------------------
    def _append(self, name: str, track: str, t0: float, t1: float,
                clock: str, attrs: dict) -> None:
        with self._lock:
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                self.dropped += 1
            seq = self._seq
            self._seq = seq + 1
            self._spans.append(Span(name, track, t0, t1, clock, seq, attrs))

    def span(self, name: str, track: str = "main", **attrs):
        """Wall-clock span context manager (no-op when disabled)."""
        if not self.enabled:
            return _NULL
        return _SpanCM(self, name, track, attrs)

    def add_span(self, name: str, t0: float, t1: float, track: str = "main",
                 clock: str = VIRTUAL, **attrs) -> None:
        """Record an already-measured interval (virtual timelines)."""
        if not self.enabled:
            return
        self._append(name, track, t0, t1, clock, attrs)

    def begin(self, name: str, track: str = "main", clock: str = WALL,
              t: Optional[float] = None, **attrs) -> Optional[_OpenSpan]:
        """Open a span whose end is not yet known (pool-slot residency,
        staleness waits).  Returns a handle for ``end``, or None when
        disabled (``end(None)`` is a no-op)."""
        if not self.enabled:
            return None
        t0 = self.now() if t is None else float(t)
        h = _OpenSpan(name, track, t0, clock, attrs)
        with self._lock:
            self._open[id(h)] = h
        return h

    def end(self, handle: Optional[_OpenSpan],
            t: Optional[float] = None, **attrs) -> None:
        if handle is None:
            return
        with self._lock:
            live = self._open.pop(id(handle), None)
        if live is None:      # tracer re-enabled/cleared since begin
            return
        t1 = self.now() if t is None else float(t)
        if attrs:
            handle.attrs.update(attrs)
        self._append(handle.name, handle.track, handle.t0, t1,
                     handle.clock, handle.attrs)

    def end_all(self, t: Optional[float] = None) -> int:
        """Close every still-open span (export calls this so residency
        spans reach the trace).  Returns how many were closed."""
        with self._lock:
            pending = list(self._open.values())
            self._open = {}
        for h in pending:
            t1 = (self.now() if h.clock == WALL else h.t0) if t is None \
                else float(t)
            self._append(h.name, h.track, h.t0, max(t1, h.t0), h.clock,
                         h.attrs)
        return len(pending)

    # -- queries -----------------------------------------------------------
    def spans(self, clock: Optional[str] = None,
              track: Optional[str] = None) -> list[Span]:
        out: Iterable[Span] = list(self._spans)
        if clock is not None:
            out = [s for s in out if s.clock == clock]
        if track is not None:
            out = [s for s in out if s.track == track]
        return list(out)

    def tracks(self, clock: Optional[str] = None) -> list[str]:
        return sorted({s.track for s in self.spans(clock=clock)})


# ---------------------------------------------------------------------------
# process default tracer
# ---------------------------------------------------------------------------

_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process default tracer; returns the previous one."""
    global _DEFAULT
    old = _DEFAULT
    _DEFAULT = tracer
    return old


def span(name: str, track: str = "main", **attrs):
    """Module-level ``with span("phase"):`` against the default tracer —
    the form the engine hot paths use (near-zero cost when disabled)."""
    t = _DEFAULT
    if not t.enabled:
        return _NULL
    return _SpanCM(t, name, track, attrs)


def traced(name: Optional[str] = None, track: str = "main"):
    """Decorator form: time every call of ``fn`` as one span."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _DEFAULT
            if not t.enabled:
                return fn(*args, **kwargs)
            with _SpanCM(t, label, track, {}):
                return fn(*args, **kwargs)

        return wrapper

    return deco
