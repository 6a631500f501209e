"""Request-lifecycle span/event tracer for the serving runtime.

CNNLab's contribution is *quantitative*: per-stage time measured on real
accelerators, not modeled.  The serving loops, by contrast, only reported
end-of-run aggregates — nobody could see where a request spent its time
across admission, prefill, the disaggregation hand-off and its decode
bursts.  This module is the measurement substrate: a tracer that records

  * **spans** — named intervals on a (track, tid) pair.  Request lifecycle
    spans live on the ``requests`` track with ``tid = rid`` (``queued``,
    ``prefill``, ``handoff``, ``decode``); engine-level spans live on one
    track per :class:`~repro_torch.serving.engine_loop.SlotEngine` (``burst``
    dispatches, ``sync`` host waits).
  * **instants** — point events (``first_token`` host visibility,
    ``kv_alloc``/``kv_free`` block-lease events, ``done``/``dropped``).
  * **counters** — sampled value series (KV occupancy, queue depth) that
    Perfetto renders as counter tracks.

Clock discipline: the tracer never calls ``time.*`` directly — it reads an
injected ``clock`` callable, and the open-loop driver installs its own skew
clock (``now_fn - t0 + idle fast-forward``) at run start, so every trace
timestamp lives on the same offered-load timeline as the serving metrics
(TTFT, latency).  Tests inject deterministic clocks and get golden traces.

Cost discipline: events append to a bounded ring buffer (old events drop,
``n_dropped`` counts them — a long-lived server never grows without bound),
and :class:`NullTracer` implements the same surface as no-ops with
``enabled = False`` so every instrumentation site can guard its argument
construction and tracing-off stays near-zero cost.

The JAX package's Chrome-trace/Perfetto exporter is not ported yet; this
module is dependency-free.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["NullTracer", "TraceEvent", "Tracer", "default_clock"]


def default_clock() -> float:
    """The one monotonic clock the runtime times with (`time.perf_counter`).

    Everything that stamps or measures time — the serving driver, the
    tracer, the launch CLIs — routes through this (or an injected override)
    so durations are never computed across mixed clock domains.
    ``time.time()`` is NOT monotonic (NTP steps it) and must not be used
    for intervals.
    """
    return time.perf_counter()


@dataclasses.dataclass
class TraceEvent:
    """One trace record.  ``ph`` follows the Chrome trace-event phases the
    exporter emits: ``X`` complete span, ``i`` instant, ``C`` counter."""

    name: str
    ph: str
    ts: float                       # seconds on the run timeline
    pid: int                        # track id (see Tracer.track)
    tid: int
    dur: Optional[float] = None     # seconds; X spans only
    cat: str = "span"
    args: Optional[dict] = None


class Tracer:
    """Span/event recorder with an injected clock and a bounded buffer."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None, *,
                 capacity: int = 65536):
        self._clock = clock or default_clock
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.n_dropped = 0
        # track registry: name -> pid, in registration order (the exporter
        # turns this into process_name metadata)
        self.tracks: Dict[str, int] = {}
        # open begin()-spans awaiting end(); handle -> (name, t0, pid, tid,
        # cat, args)
        self._open: Dict[int, tuple] = {}
        self._next_handle = 0

    # ---- clock -----------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        """Install the run's clock (the driver's skew clock) so events
        stamped with ``t=None`` land on the offered-load timeline."""
        self._clock = clock

    def now(self) -> float:
        return self._clock()

    # ---- tracks ----------------------------------------------------------
    def track(self, name: str) -> int:
        """Stable pid for a named track (``server``, ``requests``,
        ``engine:<name>``), registering it on first use."""
        pid = self.tracks.get(name)
        if pid is None:
            pid = len(self.tracks) + 1
            self.tracks[name] = pid
        return pid

    # ---- emission --------------------------------------------------------
    def _emit(self, ev: TraceEvent) -> None:
        if len(self.events) == self.capacity:
            self.n_dropped += 1          # ring: the oldest event falls out
        self.events.append(ev)

    def span(self, name: str, t0: float, t1: float, *, track: str,
             tid: int = 0, cat: str = "span",
             args: Optional[dict] = None) -> None:
        """Record a complete span with known endpoints (the lifecycle
        stamps the serving loop already carries: arrival, admission,
        phase boundary, completion)."""
        self._emit(TraceEvent(name=name, ph="X", ts=t0,
                              dur=max(t1 - t0, 0.0),
                              pid=self.track(track), tid=tid, cat=cat,
                              args=args))

    def begin(self, name: str, *, track: str, tid: int = 0,
              cat: str = "span", args: Optional[dict] = None,
              t: Optional[float] = None) -> int:
        """Open a span now; :meth:`end` closes it.  Returns a handle.
        Used where the interval is the instrumented code itself (burst
        dispatch, host syncs) rather than recorded stamps."""
        h = self._next_handle
        self._next_handle += 1
        self._open[h] = (name, self.now() if t is None else t,
                         self.track(track), tid, cat, args)
        return h

    def end(self, handle: int, *, args: Optional[dict] = None,
            t: Optional[float] = None) -> None:
        name, t0, pid, tid, cat, a0 = self._open.pop(handle)
        if args:
            a0 = {**(a0 or {}), **args}
        t1 = self.now() if t is None else t
        self._emit(TraceEvent(name=name, ph="X", ts=t0,
                              dur=max(t1 - t0, 0.0), pid=pid, tid=tid,
                              cat=cat, args=a0))

    @property
    def n_open(self) -> int:
        """Spans begun but not yet ended (0 after a well-formed run)."""
        return len(self._open)

    def instant(self, name: str, *, track: str, tid: int = 0,
                cat: str = "event", args: Optional[dict] = None,
                t: Optional[float] = None) -> None:
        self._emit(TraceEvent(name=name, ph="i",
                              ts=self.now() if t is None else t,
                              pid=self.track(track), tid=tid, cat=cat,
                              args=args))

    def counter(self, name: str, values: Dict[str, float], *, track: str,
                t: Optional[float] = None) -> None:
        """Sample a counter series (Perfetto renders one stacked counter
        track per name; ``values`` are its series)."""
        self._emit(TraceEvent(name=name, ph="C",
                              ts=self.now() if t is None else t,
                              pid=self.track(track), tid=0, cat="counter",
                              args={k: float(v) for k, v in values.items()}))

    def spans(self, name: Optional[str] = None) -> List[TraceEvent]:
        """Recorded complete spans, optionally filtered by name."""
        return [e for e in self.events
                if e.ph == "X" and (name is None or e.name == name)]

    def __len__(self) -> int:
        return len(self.events)


class NullTracer:
    """No-op tracer: the same surface, nothing recorded, near-zero cost.

    ``enabled = False`` lets instrumentation sites skip building span
    arguments entirely; the methods themselves are safe to call
    unconditionally.  ``now()`` still works (it reads the injected clock)
    so code that times an interval for a *different* consumer — e.g. the
    telemetry feedback path — can share one time source with the tracer.
    """

    enabled = False
    events: tuple = ()
    tracks: dict = {}
    n_dropped = 0
    n_open = 0

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or default_clock

    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def now(self) -> float:
        return self._clock()

    def track(self, name: str) -> int:
        return 0

    def span(self, *a, **k) -> None:
        pass

    def begin(self, *a, **k) -> int:
        return 0

    def end(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def spans(self, name: Optional[str] = None) -> list:
        return []

    def __len__(self) -> int:
        return 0
