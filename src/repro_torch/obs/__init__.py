"""Serving observability: the tracer and the metrics registry.

One :class:`Observability` bundle travels through the serving stack (driver,
engine loop, pool) so every layer instruments against the same tracer and
registry.  The default bundle is inert: a
:class:`~repro_torch.obs.trace.NullTracer` (every instrumentation site
guards on ``tracer.enabled``) and a live-but-unexported
:class:`~repro_torch.obs.metrics.MetricsRegistry`.

The JAX package's bundle also carries telemetry feedback and a performance
watchdog (both off by default there); they, the latency curves and the
Perfetto exporter are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NullTracer, TraceEvent, Tracer, default_clock

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullTracer",
    "Observability", "TraceEvent", "Tracer", "default_clock",
]


class Observability:
    """The bundle every serving layer instruments against."""

    def __init__(self, tracer=None,
                 registry: Optional[MetricsRegistry] = None):
        self.tracer = tracer if tracer is not None else NullTracer()
        self.registry = registry if registry is not None else MetricsRegistry()
