"""Serving observability: the tracer, the metrics registry, their Chrome
trace-event and JSON exports, SLO attainment and the speculative-decoding
acceptance tracker.

One :class:`Observability` bundle travels through the serving stack (driver,
engine loop, pool) so every layer instruments against the same tracer and
registry.  The default bundle is inert: a
:class:`~repro_torch.obs.trace.NullTracer` (every instrumentation site
guards on ``tracer.enabled``) and a live-but-unexported
:class:`~repro_torch.obs.metrics.MetricsRegistry`.

The JAX package's bundle also carries telemetry feedback and a performance
watchdog (both off by default there); they and the latency curves are not
ported yet (ROADMAP §1 item 6), so this bundle has neither.
"""
from __future__ import annotations

from typing import Optional

from .export import chrome_trace, trace_health, write_metrics, write_trace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NullTracer, TraceEvent, Tracer, default_clock
from .watchdog import (AcceptanceTracker, class_boundaries,
                       format_slo_report, request_class, slo_attainment)

__all__ = [
    "AcceptanceTracker", "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullTracer",
    "Observability", "TraceEvent", "Tracer", "chrome_trace",
    "class_boundaries", "default_clock", "format_slo_report",
    "request_class", "slo_attainment", "trace_health", "write_metrics",
    "write_trace",
]


class Observability:
    """The bundle every serving layer instruments against."""

    def __init__(self, tracer=None,
                 registry: Optional[MetricsRegistry] = None):
        self.tracer = tracer if tracer is not None else NullTracer()
        self.registry = registry if registry is not None else MetricsRegistry()
