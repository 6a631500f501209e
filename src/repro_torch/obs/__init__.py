"""Serving observability: the tracer, the metrics registry, their Chrome
trace-event and JSON exports, telemetry feedback into the profile cache,
fitted latency curves, the performance watchdog, SLO attainment and the
speculative-decoding acceptance tracker.

One :class:`Observability` bundle travels through the serving stack (driver,
engine loop, pool) so every layer instruments against the same tracer and
registry, and — when enabled — the telemetry feedback and the
:class:`~repro_torch.obs.watchdog.PerfWatchdog` that re-prices admission
when observed step costs drift from the admission price:

    obs = Observability(tracer=Tracer(), feedback=TelemetryFeedback(...))
    loop = EngineLoop(cfg, params, n_slots=8, max_seq=256, obs=obs)
    loop.run(requests)
    write_trace(obs.tracer, "trace.json")
    obs.feedback.flush(profile_cache)          # -> price="measured"

The default bundle is inert: a :class:`~repro_torch.obs.trace.NullTracer`
(every instrumentation site guards on ``tracer.enabled``), a
live-but-unexported :class:`~repro_torch.obs.metrics.MetricsRegistry`, and
neither feedback nor watchdog, so a burst is never synced for timing.
"""
from __future__ import annotations

from typing import Optional

from .curves import LatencyCurve, fit_latency_curve
from .export import chrome_trace, trace_health, write_metrics, write_trace
from .feedback import TelemetryFeedback
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NullTracer, TraceEvent, Tracer, default_clock
from .watchdog import (AcceptanceTracker, DriftAlert, PerfWatchdog,
                       class_boundaries, format_slo_report, request_class,
                       slo_attainment)

__all__ = [
    "AcceptanceTracker", "Counter", "DriftAlert", "Gauge", "Histogram",
    "LatencyCurve", "MetricsRegistry", "NullTracer", "Observability",
    "PerfWatchdog", "TelemetryFeedback", "TraceEvent", "Tracer",
    "chrome_trace", "class_boundaries", "default_clock",
    "fit_latency_curve", "format_slo_report", "request_class",
    "slo_attainment", "trace_health", "write_metrics", "write_trace",
]


class Observability:
    """The bundle every serving layer instruments against."""

    def __init__(self, tracer=None,
                 registry: Optional[MetricsRegistry] = None,
                 feedback: Optional[TelemetryFeedback] = None,
                 watchdog: Optional[PerfWatchdog] = None):
        self.tracer = tracer if tracer is not None else NullTracer()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.feedback = feedback
        self.watchdog = watchdog
        if watchdog is not None:
            watchdog.bind(self.registry, self.tracer)
