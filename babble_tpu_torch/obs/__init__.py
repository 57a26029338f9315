"""Observability: metrics, spans, and the attribution plane (the port's
copy of the JAX package's ``obs``, kept equal to it: the Prometheus text
of a ``Registry`` is byte-equal for the same observations).

Stdlib-only by contract.  Three tiers:

- :mod:`.metrics` — Counter/Gauge/Histogram registry with
  Prometheus-text exposition (served at ``/metrics`` by
  ``service.Service``), safe from the event loop and the worker
  threads that drive the device pipeline.
- :mod:`.spans` — bounded-ring span tracer with a context-manager /
  decorator API; parent/child wall-clock trees for a full
  submit→gossip→device-step→commit cycle (served at ``/debug/spans``).
  :mod:`.probe` — asyncio event-loop-lag probe.
- :mod:`.lineage` + :mod:`.flight` — the cross-node tier:
  per-tx/per-event lifecycle ledgers hash-joined fleet-wide into one
  stitched timeline (``/debug/lineage`` + ``fleet trace``), and the
  bounded state-transition ring every crash and chaos violation dumps
  (``/debug/flight``).

Each :class:`~babble_tpu_torch.node.node.Node` owns one of each; fleet-wide
collection is a sweep (``fleet scrape`` / ``fleet health`` /
``fleet trace``).
"""

from .flight import FlightRecorder
from .lineage import LineageRecorder, stitch, tx_id
from .metrics import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    Registry,
)
from .probe import LoopLagProbe
from .spans import SpanTracer

__all__ = [
    "LATENCY_BUCKETS",
    "SIZE_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LineageRecorder",
    "MetricFamily",
    "Registry",
    "LoopLagProbe",
    "SpanTracer",
    "stitch",
    "tx_id",
]
