"""``ServeEngine`` — K personalized models answered in one launch per
layer (reference ``repro.serve.engine``).

The serving loop is: micro-batch pending requests (``batcher.py``, one
request per user per launch), acquire each request's personalized model
in the store's slot pool (``store.py`` — misses decode into a slot, hits
move zero parameter bytes), place the request inputs at their models'
slots in a ``(cache_size, rows, d_in)`` host buffer, copy it to the device
once, and score the whole pool with ONE batched forward — for the MLP that
is the user-major masked-matmul kernel, one launch per layer.  The launch
operand IS the device-resident pool, so every launch has the same shapes.

Latency accounting, as the reference's: arrivals are *virtual*
(seed-derived, ``batcher.RequestStream``) while the launch is wall-clock
measured end to end — slot acquisition (miss decodes included), input
placement and copy, the batched forward, a device synchronise and the copy
of the outputs back to the host.  The forward is compiled
(``utils.graph.graphed``: a CUDA graph on the card, as the reference
jits it); ``warmup()`` takes its capture for the store's pool, so none
lands in a request's service time.  A request's reported latency is its
virtual queue wait plus the wall service time of its launch.  p50/p99
latency and requests/s stream as JSON lines through
``sim.report.MetricsStream``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.obs import VIRTUAL, LogHistogram, SeriesSet, get_tracer, span
from repro_torch.serve.batcher import MicroBatcher, Request, RequestStream
from repro_torch.serve.store import ModelStore
from repro_torch.utils.graph import new_pools


@dataclasses.dataclass
class ServeResult:
    """Latency distributions are ``LogHistogram`` sketches (bounded memory,
    quantiles within 1% relative error, one shared bucket grid)."""
    outputs: dict[int, np.ndarray]       # rid -> model output
    latency_ms: LogHistogram             # wait + service, per request
    wait_ms: LogHistogram                # virtual queue wait component
    service_ms: LogHistogram             # wall launch-service component
    summary: dict

    @property
    def p50_ms(self) -> float:
        return self.latency_ms.quantile(0.5)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms.quantile(0.99)


class ServeEngine:
    """Batched multi-tenant serving over a ``ModelStore``, on the store's
    device.

    ``backend`` picks the batched forward (``model.backends()``): ``vmap``,
    ``ref`` (the plain batched masked matmul) or ``kernel`` (the CUDA
    kernel on CUDA tensors).  A launch scores the whole slot pool, so a
    batch holds at most one request per user and at most
    ``store.cache_size`` requests; ``max_batch`` is clamped to the pool
    size.
    """

    def __init__(self, store: ModelStore, model, backend: str = "vmap",
                 max_batch: int = 8, max_wait: float = 0.005, metrics=None,
                 metrics_every: int = 8):
        if backend not in model.backends():
            raise ValueError(
                f"backend {backend!r} not supported by this model "
                f"(supports {model.backends()})")
        self.store = store
        self.model = model
        self.backend = backend
        self.max_batch = min(int(max_batch), store.cache_size)
        self.max_wait = float(max_wait)
        self.metrics = metrics
        self.metrics_every = int(metrics_every)
        self.series = SeriesSet("serve.engine")
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------------
    def _forward(self, x_pool: np.ndarray) -> np.ndarray:
        """One pool-wide batched forward: the inputs go to the device once,
        the outputs come back after a synchronise."""
        dev = self.store.device
        xs = torch.from_numpy(x_pool).to(dev)
        y = self.model.batched_forward(self.store.pool_params,
                                       self.store.pool_masks, xs,
                                       backend=self.backend)
        synchronize(dev)
        return y.cpu().numpy()

    def _launch(self, reqs: Sequence[Request],
                xs: Sequence[np.ndarray]) -> tuple[np.ndarray, float]:
        """Acquire slots, place inputs, one pool-wide batched forward.
        Returns (outputs for the requests, wall service seconds — the
        whole launch including miss decodes and the input copy).  ``xs``
        are the request payloads, built by ``serve`` outside the service
        clock: payload arrival is not serving work."""
        t0 = time.perf_counter()
        with span("serve.launch", track="serve", batch=len(reqs)):
            with span("serve.acquire", track="serve"):
                slots = [self.store.acquire(r.user) for r in reqs]
            assert len(set(slots)) == len(slots), \
                "batch holds two requests for one pool slot (same user?)"
            with span("serve.scatter", track="serve"):
                x_pool = np.zeros((self.store.cache_size,) + xs[0].shape,
                                  dtype=xs[0].dtype)
                for s, x in zip(slots, xs):
                    x_pool[s] = x
            with span("serve.forward", track="serve"):
                y = self._forward(x_pool)
        service_s = time.perf_counter() - t0
        return y[np.asarray(slots)], service_s

    def warmup(self) -> float:
        """One throwaway pool-wide launch (zero inputs, current pool) so
        first-call costs (kernel build and load, allocator growth, on the
        card the forward's capture for this store's pool) never land in a
        request's latency.  Touches no slots and no counters.  Returns its
        seconds."""
        x0 = self.model.make_input(0)
        x_pool = np.zeros((self.store.cache_size,) + x0.shape,
                          dtype=x0.dtype)
        t0 = time.perf_counter()
        with new_pools():
            self._forward(x_pool)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def serve(self, requests: Sequence[Request] | RequestStream,
              warmup: bool = True) -> ServeResult:
        """Serve ``requests``; ``warmup=False`` skips the throwaway launch
        (a warm engine serving one request at a time)."""
        warm_s = self.warmup() if warmup else 0.0

        batcher = MicroBatcher(requests, max_batch=self.max_batch,
                               max_wait=self.max_wait,
                               resident=self.store.resident)
        outputs: dict[int, np.ndarray] = {}
        lat_h = LogHistogram()
        wait_h = LogHistogram()
        service_h = LogHistogram()
        service_total = 0.0
        n_batches = 0
        n_served = 0
        t_wall0 = time.perf_counter()
        tr = get_tracer()
        for batch in batcher.batches():
            xs = [self.model.make_input(r.input_seed)
                  for r in batch.requests]
            y, service_s = self._launch(batch.requests, xs)
            service_total += service_s
            n_batches += 1
            n_served += len(batch.requests)
            for i, (req, wait) in enumerate(
                    zip(batch.requests, batch.queue_waits())):
                outputs[req.rid] = y[i]
                lat_h.add(wait * 1e3 + service_s * 1e3)
                wait_h.add(wait * 1e3)
                service_h.add(service_s * 1e3)
                if tr.enabled:
                    # batcher wait on the request's virtual timeline — the
                    # queueing component of its reported latency
                    tr.add_span("request.wait", req.t_arrival, batch.t_flush,
                                track=f"user/{req.user}", clock=VIRTUAL,
                                rid=req.rid)
            if self.metrics and n_batches % self.metrics_every == 0:
                self.metrics.emit({
                    "event": "serve", "batches": n_batches,
                    "served": n_served,
                    "p50_ms": round(lat_h.quantile(0.5), 3),
                    "p99_ms": round(lat_h.quantile(0.99), 3),
                    "cache_hits": self.store.hits,
                    "cache_misses": self.store.misses,
                })
        wall_s = time.perf_counter() - t_wall0

        st = self.store.stats()
        summary = {
            "event": "summary",
            "backend": self.backend,
            "requests": n_served,
            "batches": n_batches,
            "mean_batch": round(n_served / max(n_batches, 1), 2),
            "p50_ms": round(lat_h.quantile(0.5), 3),
            "p99_ms": round(lat_h.quantile(0.99), 3),
            "p50_wait_ms": round(wait_h.quantile(0.5), 3),
            "p99_wait_ms": round(wait_h.quantile(0.99), 3),
            "p50_service_ms": round(service_h.quantile(0.5), 3),
            "p99_service_ms": round(service_h.quantile(0.99), 3),
            "requests_per_s": round(n_served / max(service_total, 1e-9), 1),
            "service_s": round(service_total, 4),
            "wall_s": round(wall_s, 4),
            "warmup_s": round(warm_s, 4),
            "cache_hit_rate": round(
                st["hits"] / max(st["hits"] + st["misses"], 1), 4),
            **{f"store_{k}": v for k, v in st.items()},
        }
        # fold this call into the engine-lifetime observability surface
        self.series.histogram("latency_ms").merge(lat_h)
        self.series.histogram("wait_ms").merge(wait_h)
        self.series.histogram("service_ms").merge(service_h)
        tw = time.perf_counter() - self._epoch
        self.series.series("requests", kind="counter").observe(
            tw, self.series.histogram("latency_ms").count)
        self.series.series("requests_per_s").observe(
            tw, summary["requests_per_s"])
        if self.metrics:
            self.metrics.emit(summary)
        return ServeResult(outputs=outputs, latency_ms=lat_h,
                           wait_ms=wait_h, service_ms=service_h,
                           summary=summary)
