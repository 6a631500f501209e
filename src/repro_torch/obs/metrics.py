"""Serving-wide metrics registry: counters, gauges, histograms, snapshots.

Before this module the serving runtime's numbers lived in four ad-hoc
places — ``ServeMetrics`` aggregate lists, the ``HandoffLedger``'s own
counters, end-of-run ``KVPool.stats()``, and the ``ContinuousBatcher``'s
admitted/rejected/deferred tallies — and only *means* survived the run
(``kv_occupancy_mean`` told you nothing about the occupancy spike that
deferred half the queue).  The registry unifies them:

  * **counters** — monotone totals (requests done, hand-off bytes moved);
  * **gauges** — last-written values (queue depth, KV occupancy, slots in
    flight), which the driver refreshes every iteration;
  * **histograms** — bounded samples with percentile summaries (TTFT,
    TPOT, latency — what ``ServeMetrics`` keeps as raw lists);
  * **time series** — :meth:`MetricsRegistry.sample` snapshots every gauge
    at the driver's iteration cadence into a bounded ring, so the run's
    occupancy/queue-depth/in-flight *trajectories* survive, not just their
    means.

Everything is plain floats and dicts and :meth:`snapshot` returns a
JSON-safe tree.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


@dataclasses.dataclass
class Counter:
    """Monotone total.  ``inc`` with a negative amount is a bug upstream."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Last-written value (sampled into the time series by the driver)."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded sample reservoir with percentile summaries.

    Keeps the newest ``capacity`` observations (a serving run's TTFT list
    is small; a long-lived server's is not) plus a monotone total count.
    """

    def __init__(self, name: str, *, capacity: int = 65536):
        self.name = name
        self.samples: deque = deque(maxlen=capacity)
        self.count = 0

    def observe(self, v: float) -> None:
        self.samples.append(float(v))
        self.count += 1

    def summary(self) -> Dict[str, Optional[float]]:
        """Percentile summary; ``None`` (JSON null) when empty — never NaN,
        so a zero-completion run still serializes as strict JSON."""
        if not self.samples:
            return {"count": self.count, "n_samples": 0, "mean": None,
                    "p50": None, "p99": None, "min": None, "max": None}
        xs = np.asarray(self.samples)
        return {
            "count": self.count,
            # retained reservoir size: < count means the ring truncated and
            # the percentiles below only describe the newest samples
            "n_samples": len(self.samples),
            "mean": float(xs.mean()),
            "p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "min": float(xs.min()),
            "max": float(xs.max()),
        }


class MetricsRegistry:
    """Create-or-get registry + the sampled gauge time series."""

    def __init__(self, *, series_capacity: int = 8192,
                 histogram_capacity: int = 65536):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.series: deque = deque(maxlen=series_capacity)
        self.n_samples = 0               # ever taken (ring may have dropped)
        self._hist_capacity = histogram_capacity

    # ---- create-or-get ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                name, capacity=self._hist_capacity)
        return h

    # ---- time series -----------------------------------------------------
    def sample(self, t: float) -> None:
        """Snapshot every gauge at time ``t`` into the series ring — the
        in-run trajectory (KV occupancy, queue depth, in-flight slots)
        end-of-run means cannot reconstruct."""
        point = {"t": float(t)}
        for name, g in self.gauges.items():
            point[name] = g.value
        self.series.append(point)
        self.n_samples += 1

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe dump: counter/gauge values, histogram summaries, and
        the sampled time series (newest ``series_capacity`` points)."""
        return {
            "counters": {n: c.value for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
            "series": [dict(p) for p in self.series],
            "n_samples": self.n_samples,
            "series_len": len(self.series),
            "series_dropped": self.n_samples - len(self.series),
        }

    def series_values(self, name: str) -> List[float]:
        """One gauge's sampled trajectory (points recorded before the gauge
        first existed are skipped)."""
        return [p[name] for p in self.series if name in p]
