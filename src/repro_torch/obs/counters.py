"""Typed monotonic counters and gauges with a process-wide registry
(reference ``repro.obs.counters``, copied line for line).

A ``CounterSet`` is a named bundle an engine/store owns (``serve.store``,
``sparse.codec``, ...).  Sets register themselves in a weak registry, so
``snapshot_counters()`` can collect every live metric in the process as
flat ``namespace/name -> value`` rows.

Two metric types:

* ``Counter`` — monotonic (``inc`` rejects negative deltas).
* ``Gauge`` — a point-in-time value, either set explicitly or computed by
  a callback at read time.

The reference's ``jax.monitoring`` compile-event bridge
(``install_jax_hooks``, ``jax_compile_count``) becomes
``torch_compile_count``: the graphs ``torch.compile`` has compiled in this
process, which ``ScaleEngine`` snapshots around its round step.
"""
from __future__ import annotations

import sys
import threading
import weakref
from typing import Callable, Optional

class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic; cannot inc by {n}")
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def __int__(self) -> int:
        return int(self.value)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Point-in-time value: explicit ``set`` or a read-time callback."""

    __slots__ = ("name", "_fn", "_value")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._fn = fn
        self._value = 0

    def set(self, v) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name!r} is callback-backed")
        self._value = v

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Gauge({self.name}={self.value})"


_REGISTRY: "weakref.WeakSet[CounterSet]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


class CounterSet:
    """A namespaced bundle of counters/gauges, weakly registered process-wide.

    The owner (engine, store, codec module) holds the only strong
    reference, so a set disappears from snapshots when its owner does.
    """

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._metrics: dict[str, Counter | Gauge] = {}
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        elif not isinstance(m, Counter):
            raise TypeError(f"{self.namespace}/{name} is a {type(m).__name__}")
        return m

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name, fn)
        elif not isinstance(m, Gauge):
            raise TypeError(f"{self.namespace}/{name} is a {type(m).__name__}")
        return m

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> dict:
        return {name: m.value for name, m in sorted(self._metrics.items())}


def snapshot_counters(prefix: Optional[str] = None) -> dict:
    """Flat ``namespace/name -> value`` over every live ``CounterSet``;
    same-key metrics from multiple sets (several engines in one process)
    sum."""
    with _REGISTRY_LOCK:
        sets = list(_REGISTRY)
    out: dict[str, float] = {}
    for cs in sorted(sets, key=lambda s: s.namespace):
        if prefix is not None and not cs.namespace.startswith(prefix):
            continue
        for name, value in cs.snapshot().items():
            key = f"{cs.namespace}/{name}"
            out[key] = out.get(key, 0) + value
    return out


def torch_compile_count() -> int:
    """Graphs compiled by ``torch.compile`` (TorchDynamo) in this process;
    0 while nothing has imported ``torch._dynamo``, since then nothing has
    been compiled.  Snapshot before/after a call to detect compiles."""
    if "torch._dynamo" not in sys.modules:
        return 0
    from torch._dynamo.utils import counters
    return int(counters["stats"]["unique_graphs"])
