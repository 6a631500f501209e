"""Chrome trace-event / Perfetto JSON export + flat metrics dump (the JAX
package's ``obs/export.py``).

The tracer records seconds on the run timeline; Chrome trace-event wants
microseconds, per-track ``process_name`` metadata, and *strict* JSON (the
``chrome://tracing`` and Perfetto loaders reject the non-standard ``NaN``
token, so both writers pass ``allow_nan=False`` — a NaN reaching export is
a bug upstream, not something to paper over).

Track mapping: each :meth:`Tracer.track` name becomes one pid with an
``M``/``process_name`` record (``server``, ``requests``,
``engine:<name>``); tids within a track are request ids (``requests``) or
slot 0 (engine tracks).  Request lifecycle spans carry their args
(priced vs observed cost, block lease sizes) through to Perfetto's span
detail pane.
"""
from __future__ import annotations

import json
from typing import Optional

__all__ = ["chrome_trace", "trace_health", "write_metrics", "write_trace"]

_US = 1e6


def _safe(v):
    """JSON-strict coercion for span args: numpy scalars -> python, floats
    that cannot serialize (nan/inf) -> None, unknown objects -> repr."""
    if isinstance(v, dict):
        return {str(k): _safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_safe(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if hasattr(v, "item"):            # numpy scalar
        v = v.item()
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else None
    if isinstance(v, int):
        return v
    return repr(v)


def chrome_trace(tracer) -> dict:
    """The tracer's buffer as a Chrome trace-event object (JSON-safe)."""
    events = []
    for name, pid in tracer.tracks.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
    for ev in tracer.events:
        rec = {"name": ev.name, "ph": ev.ph, "cat": ev.cat,
               "ts": round(ev.ts * _US, 3), "pid": ev.pid, "tid": ev.tid}
        if ev.ph == "X":
            rec["dur"] = round((ev.dur or 0.0) * _US, 3)
        elif ev.ph == "i":
            rec["s"] = "t"               # instant scope: thread
        if ev.args:
            rec["args"] = _safe(ev.args)
        events.append(rec)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"n_dropped": tracer.n_dropped,
                          "n_open": tracer.n_open}}


def write_trace(tracer, path: str) -> str:
    """Dump the trace as strict JSON (loads in Perfetto /
    ``chrome://tracing``)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, allow_nan=False)
    return path


def trace_health(tracer) -> dict:
    """Ring-buffer accounting for the metrics snapshot.

    A saturated ring silently drops the oldest spans, so an exported trace
    can *look* complete while missing the run's start; surfacing
    ``n_dropped`` (and still-open span count) next to the metrics makes
    the truncation visible without opening the trace itself.
    """
    return {"n_events": len(tracer.events),
            "n_dropped": tracer.n_dropped,
            "n_open": tracer.n_open,
            "enabled": bool(tracer.enabled)}


def write_metrics(registry, path: str, *, tracer=None,
                  extra: Optional[dict] = None) -> str:
    """Dump the registry snapshot (counters, gauges, histogram summaries,
    sampled time series) as strict JSON; ``tracer`` adds its ring-buffer
    health under ``trace``; ``extra`` merges top-level keys (e.g. the
    run's ServeMetrics summary)."""
    data = registry.snapshot()
    if tracer is not None:
        data["trace"] = trace_health(tracer)
    if extra:
        data.update(_safe(extra))
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True, allow_nan=False)
    return path
