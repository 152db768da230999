"""repro_torch.sim — event-driven asynchronous P2P network simulator
(reference ``repro.sim``).

Answers the deployment questions on real links: how long decentralized
sparse training takes, what the busiest node actually uploads and
downloads, and when asynchronous gossip beats the synchronous barrier.

Modules
-------
``events``        event queue, virtual clock, per-client compute speeds
``links``         per-edge bandwidth/latency models (time-varying via
                  ``BandwidthTrace``), shared-uplink scheduling
                  (``UplinkScheduler``: parallel/fifo/fair), Bernoulli
                  message loss + retransmit (``LossModel``), and measured
                  bytes-on-wire (retransmitted bytes included)
``availability``  Bernoulli / trace-driven client up-down schedules (shared
                  with the engine's ``drop_prob``)
``async_engine``  ``SimEngine`` — drives the Strategy hooks in a
                  synchronous (bit-identical to ``RoundEngine``) or
                  staleness-bounded asynchronous regime; checkpoint/resume
                  of the *complete* simulation is bit-identical to an
                  uninterrupted run in both modes
``report``        wall-clock-to-target, busiest-node timelines, per-link
                  utilization, retransmit overhead, JSON-lines streaming

Entry points: ``SimEngine``; ``python -m repro_torch.launch.train simulate
--sim [--async ...]``.
"""
from repro_torch.sim.availability import (  # noqa: F401
    AlwaysUp,
    Availability,
    BernoulliAvailability,
    TraceAvailability,
    dropping_trace,
)
from repro_torch.sim.events import (  # noqa: F401
    ComputeModel,
    Event,
    EventQueue,
    VirtualClock,
    hetero_speeds,
)
from repro_torch.sim.links import (  # noqa: F401
    BandwidthTrace,
    LinkModel,
    LinkStats,
    LossModel,
    UplinkScheduler,
    measure_payload,
)
from repro_torch.sim.async_engine import SimEngine, SimRoundMetrics  # noqa: F401
from repro_torch.sim.report import MetricsStream, SimReport, build_report  # noqa: F401
