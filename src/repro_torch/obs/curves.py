"""Fitted latency(batch) curves from serving telemetry (the JAX package's
``obs/curves.py``).

The admission batcher prices a decode step with the analytic roofline sum
(`serving.batcher.step_time_model`), which scales linearly in FLOPs between
batch sizes.  Serving telemetry — the per-burst timings `PerfWatchdog`
collects, or the `source=serving-telemetry` entries `TelemetryFeedback`
writes into the profile cache — gives real (batch, step seconds) points.
This module turns those points into a monotone piecewise-linear curve the
batcher can price against instead.

Latency(batch) on real hardware is non-decreasing, but raw medians from a
live run need not be (noise, a graph capture inside a burst).  The fit
enforces monotonicity with pool-adjacent-violators isotonic regression and
reports per-knot residuals so the export can show how far the raw points
were pulled.

Fewer than two distinct batch sizes is not a curve: ``fit_latency_curve``
returns ``None`` and callers fall back to the analytic model (possibly
scaled by the watchdog's observed divergence ratio).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.cost_model import piecewise_interp

__all__ = ["LatencyCurve", "MIN_CURVE_POINTS", "curve_points_from_cache",
           "fit_latency_curve", "isotonic_fit", "median_points"]

MIN_CURVE_POINTS = 2


def isotonic_fit(ys: Sequence[float]) -> List[float]:
    """Pool-adjacent-violators: least-squares non-decreasing fit of ``ys``."""
    # each block: [level, weight] — merge backwards while out of order
    blocks: List[List[float]] = []
    for y in ys:
        blocks.append([float(y), 1.0])
        while len(blocks) > 1 and blocks[-2][0] > blocks[-1][0]:
            level, w = blocks.pop()
            plevel, pw = blocks.pop()
            tot = w + pw
            blocks.append([(level * w + plevel * pw) / tot, tot])
    out: List[float] = []
    for level, w in blocks:
        out.extend([level] * int(round(w)))
    return out


@dataclasses.dataclass(frozen=True)
class LatencyCurve:
    """Monotone piecewise-linear step-seconds(batch) fitted from telemetry."""

    batches: Tuple[int, ...]          # strictly increasing knot batch sizes
    step_s: Tuple[float, ...]         # isotonic-fitted seconds per knot
    raw_step_s: Tuple[float, ...]     # observed medians before the fit
    source: str = "serving-telemetry"

    @property
    def n_points(self) -> int:
        return len(self.batches)

    def predict(self, n_tokens: int) -> float:
        """Step seconds at ``n_tokens``, interpolating between fitted knots."""
        return piecewise_interp(
            [float(b) for b in self.batches], list(self.step_s),
            float(max(int(n_tokens), 1)))

    def residuals(self) -> Dict[int, float]:
        """Per-knot relative residual |fitted - observed| / observed."""
        out: Dict[int, float] = {}
        for b, fit, raw in zip(self.batches, self.step_s, self.raw_step_s):
            out[b] = abs(fit - raw) / raw if raw > 0 else 0.0
        return out

    def max_batch_within(self, slo_s: float, n_slots: int) -> int:
        """Largest batch (1..n_slots) whose predicted step fits the SLO."""
        budget = 1
        for k in range(2, max(int(n_slots), 1) + 1):
            if self.predict(k) > slo_s:
                break
            budget = k
        return budget

    def summary(self) -> dict:
        """JSON-safe description for the metrics snapshot / watchdog report."""
        return {
            "batches": list(self.batches),
            "step_s": [float(v) for v in self.step_s],
            "raw_step_s": [float(v) for v in self.raw_step_s],
            "residuals": {str(b): float(r)
                          for b, r in sorted(self.residuals().items())},
            "source": self.source,
        }


def fit_latency_curve(points: Mapping[int, float], *,
                      source: str = "serving-telemetry",
                      ) -> Optional[LatencyCurve]:
    """Fit a monotone curve through ``{batch: median step seconds}``.

    Returns ``None`` when fewer than :data:`MIN_CURVE_POINTS` distinct
    batches carry a positive timing — a single point fixes a scale but not
    a shape, so the caller keeps the analytic model.
    """
    clean = sorted((int(b), float(t)) for b, t in points.items()
                   if int(b) >= 1 and float(t) > 0.0)
    if len(clean) < MIN_CURVE_POINTS:
        return None
    batches = tuple(b for b, _ in clean)
    raw = tuple(t for _, t in clean)
    fitted = tuple(isotonic_fit(raw))
    return LatencyCurve(batches=batches, step_s=fitted, raw_step_s=raw,
                        source=source)


def median_points(samples: Mapping[int, Sequence[float]]) -> Dict[int, float]:
    """Collapse per-batch step-seconds samples to per-batch medians."""
    return {int(b): float(statistics.median(xs))
            for b, xs in samples.items() if len(xs) > 0}


def curve_points_from_cache(cache, cfg, *, kv_len: int,
                            engine: str = "torch",
                            dtype: str = "float32") -> Dict[int, float]:
    """Reconstruct {batch: step seconds} from fed profile-cache entries.

    `TelemetryFeedback.flush` apportions each observed decode step across
    the decode network's layers and tags the entries
    ``source=serving-telemetry``; summing the per-layer medians back up per
    batch recovers the observed step time that batch cost — feedable
    straight into :func:`fit_latency_curve` on a later run.  ``cache`` is
    the port's :class:`~repro_torch.profiling.cache.ProfileCache`, whose
    lookups see only entries of its own device's environment.
    """
    # keep `repro_torch.obs` importable without the serving stack
    from ..serving.batcher import decode_network_spec

    net = decode_network_spec(cfg, kv_len)
    fed = cache.measurements(engine=engine, source="serving-telemetry")
    batches = sorted({int(m["batch"]) for m in fed})
    points: Dict[int, float] = {}
    for batch in batches:
        total = 0.0
        complete = True
        for spec in net:
            m = cache.get(spec, engine, batch=batch, dtype=dtype)
            if m is not None and m.get("source") == "serving-telemetry":
                total += float(m["t_median"])
            elif spec.flops(batch) > 0:
                complete = False  # a priced layer is missing: partial step
                break
        if complete and total > 0.0:
            points[batch] = total
    return points
