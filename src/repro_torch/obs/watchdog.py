"""Online performance watchdog (priced-vs-observed drift detection and
re-pricing), SLO attainment for ``serve --slo-report`` and the
speculative-decoding acceptance tracker: the JAX package's
``obs/watchdog.py``.

:class:`PerfWatchdog` subscribes to the serving loop's synced burst stream,
keeps a per-(engine, phase) EWMA of the observed/priced step-time ratio,
fits :mod:`~repro_torch.obs.curves` latency(batch) curves from the
accumulated points, and raises structured :class:`DriftAlert` events once
warm divergence clears the gate.  It only detects; acting is the serving
loop's job.  The driver drains :meth:`PerfWatchdog.pending_actions` at
burst boundaries and hands each alert to the loop's ``on_drift`` hook, which
re-prices the matching `ContinuousBatcher` (fitted curve when >= 2 batch
sizes were observed, ratio-scaled analytic otherwise) and reports back via
:meth:`PerfWatchdog.note_reprice`, which re-arms the detector.

Cold bursts.  The JAX package skips the first burst per (engine, phase,
power-of-two batch bucket), because its engine compiles one program per
bucket and that burst's time holds the compile.  The port steps every batch
size through one CUDA graph and has no buckets; it keeps the rule verbatim,
so the watchdog's arithmetic on a given burst stream is the JAX package's
exactly.  On the card the burst it skips first is therefore the first
replay of the graph after ``SlotEngine.warmup()`` captured it, and one more
at each new bucket.

Requests are bucketed by generation length into short/medium/long terciles
for the SLO report, and each class reports its TTFT/TPOT medians and the
share of requests that met each objective.  :class:`AcceptanceTracker`
follows the draft's measured acceptance rate and vetoes speculation when a
re-decision prices it worse than plain decoding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from .curves import LatencyCurve, fit_latency_curve, median_points

__all__ = ["AcceptanceTracker", "DEFAULT_ACCEPTANCE_REDECIDE_EVERY",
           "DEFAULT_DRIFT_GATE", "DEFAULT_EWMA_ALPHA", "DEFAULT_WARMUP",
           "DriftAlert", "PerfWatchdog",
           "class_boundaries", "format_slo_report", "request_class",
           "slo_attainment"]

# drift gate: alert when EWMA(observed / priced) leaves [1/gate, gate]
DEFAULT_DRIFT_GATE = 1.5
DEFAULT_EWMA_ALPHA = 0.4
DEFAULT_WARMUP = 4
# cold-start skip: the first burst per (engine, phase, batch bucket).  The
# JAX package's engine compiles one program per power-of-two batch bucket,
# so there a first visit holds a compile that would poison the EWMA and
# plant a polluted knot in the fitted curve; the port keeps the rule as it
# is (module docstring), and on the card its first skip is the first replay
# of the captured step graph
SKIP_FIRST = 1


def _bucket(n_tokens: int) -> int:
    """Power-of-two batch bucket (the JAX package's jit bucketing).  The
    port's one step graph has no buckets, so on the card this discards a
    warm burst at each new bucket; it stays only so that the watchdog's
    arithmetic on a burst stream is the JAX package's exactly, which
    tests/test_torch_obs.py holds it to."""
    b = 1
    while b < n_tokens:
        b <<= 1
    return b


# sync-cadence pressure: drain-sync cost above this fraction of burst cost
# stretches the streaming sync cadence (k), bounded by MAX_SYNC_EVERY
SYNC_BUDGET_FRAC = 0.25
MAX_SYNC_EVERY = 4


@dataclasses.dataclass(frozen=True)
class DriftAlert:
    """One gate crossing for one (engine, phase) pricing stream."""

    engine: str
    phase: str
    t: float                  # trace-clock time of the triggering burst
    ewma_ratio: float         # EWMA of observed/priced at trigger
    priced_step_s: float      # price of the triggering burst
    observed_step_s: float    # observed per-step cost of that burst
    n_obs: int                # observations since the last re-price
    batch: int                # tokens in flight at trigger
    direction: str            # "slow": observed > priced; "fast": priced > observed

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _PhaseState:
    """Per-(engine, phase) detector state."""

    __slots__ = ("ewma", "n_obs", "seen", "samples", "alert_active",
                 "n_alerts")

    def __init__(self) -> None:
        self.ewma: Optional[float] = None
        self.n_obs = 0                       # observations since last action
        self.seen: Dict[int, int] = {}       # bucket -> bursts seen (incl. skips)
        self.samples: Dict[int, List[float]] = {}   # batch -> step seconds
        self.alert_active = False
        self.n_alerts = 0


class PerfWatchdog:
    """Detects priced-vs-observed drift and brokers the re-pricing loop.

    Invariants: the watchdog is detection-only — it never touches engine
    state or request outputs, and the re-pricing it brokers is pure
    admission policy (greedy outputs are schedule-independent, so a
    re-price can change *when* requests run but never *what* they decode).
    It holds no clock of its own: every timing it sees arrives as an
    ``elapsed_s`` measured by the serving loop on the injected run clock, so
    tests can drive it deterministically and trace timestamps stay on the
    run's timeline.  The only runtime cost it adds is the per-burst device
    sync the loop performs to time bursts honestly — a pure wait,
    output-neutral by construction."""

    def __init__(self, *, ewma_alpha: float = DEFAULT_EWMA_ALPHA,
                 drift_gate: float = DEFAULT_DRIFT_GATE,
                 warmup: int = DEFAULT_WARMUP):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if drift_gate <= 1.0:
            raise ValueError("drift_gate must be > 1")
        self.ewma_alpha = ewma_alpha
        self.drift_gate = drift_gate
        self.warmup = max(int(warmup), 1)

        self._states: Dict[Tuple[str, str], _PhaseState] = {}
        self.alerts: List[DriftAlert] = []
        self.reprices: List[dict] = []
        self._pending: List[DriftAlert] = []
        self._sync_ewma: Optional[float] = None
        self._burst_ewma: Optional[float] = None
        self._registry = None
        self._tracer = None

    def bind(self, registry, tracer) -> None:
        """Attach the run's metrics registry + tracer (Observability does)."""
        self._registry = registry
        self._tracer = tracer

    # ---- observation ------------------------------------------------------
    def _state(self, engine: str, phase: str) -> _PhaseState:
        return self._states.setdefault((engine, phase), _PhaseState())

    def _ewma_update(self, prev: Optional[float], x: float) -> float:
        if prev is None:
            return x
        return (1.0 - self.ewma_alpha) * prev + self.ewma_alpha * x

    def observe_burst(self, engine: str, phase: str, *, n_tokens: int,
                      steps: int, elapsed_s: float,
                      priced_step_s: float) -> Optional[DriftAlert]:
        """Feed one synced burst; returns the alert if this one crossed."""
        if n_tokens <= 0 or steps <= 0 or elapsed_s <= 0.0:
            return None
        st = self._state(engine, phase)
        bucket = _bucket(int(n_tokens))
        st.seen[bucket] = st.seen.get(bucket, 0) + 1
        if st.seen[bucket] <= SKIP_FIRST:
            return None              # cold-start burst at this batch bucket
        observed = elapsed_s / steps
        st.samples.setdefault(int(n_tokens), []).append(observed)
        self._burst_ewma = self._ewma_update(self._burst_ewma, elapsed_s)

        if priced_step_s <= 0.0:
            return None
        ratio = observed / priced_step_s
        st.ewma = self._ewma_update(st.ewma, ratio)
        st.n_obs += 1

        reg, tracer = self._registry, self._tracer
        if reg is not None:
            reg.counter("watchdog_observations").inc()
            reg.gauge(f"drift_{engine}_{phase}").set(st.ewma)
        if tracer is not None and tracer.enabled:
            tracer.counter("drift", {f"{engine}/{phase}": st.ewma},
                           track="watchdog")

        gated = st.ewma > self.drift_gate or st.ewma < 1.0 / self.drift_gate
        if st.alert_active or st.n_obs < self.warmup or not gated:
            return None
        t = tracer.now() if tracer is not None else 0.0
        alert = DriftAlert(
            engine=engine, phase=phase, t=t, ewma_ratio=st.ewma,
            priced_step_s=priced_step_s, observed_step_s=observed,
            n_obs=st.n_obs, batch=int(n_tokens),
            direction="slow" if st.ewma > 1.0 else "fast")
        st.alert_active = True
        st.n_alerts += 1
        self.alerts.append(alert)
        self._pending.append(alert)
        if reg is not None:
            reg.counter("watchdog_alerts").inc()
        if tracer is not None and tracer.enabled:
            tracer.instant("drift_alert", track="server", cat="watchdog",
                           args=alert.to_dict(), t=t)
        return alert

    def observe_sync(self, elapsed_s: float) -> None:
        """Feed one drain-sync cost (the streaming TokenSink boundary)."""
        if elapsed_s < 0.0:
            return
        self._sync_ewma = self._ewma_update(self._sync_ewma, elapsed_s)

    # ---- queries ----------------------------------------------------------
    def ewma(self, engine: str, phase: str) -> Optional[float]:
        st = self._states.get((engine, phase))
        return st.ewma if st is not None else None

    def curve(self, engine: str, phase: str) -> Optional[LatencyCurve]:
        """Fitted latency(batch) curve; None until >= 2 batch sizes seen."""
        st = self._states.get((engine, phase))
        if st is None:
            return None
        return fit_latency_curve(median_points(st.samples))

    def step_time_fn(self, engine: str, phase: str,
                     analytic_fn: Callable[[int], float],
                     ) -> Tuple[Callable[[int], float], str]:
        """Best available pricing for (engine, phase).

        Fitted curve when the run observed >= 2 distinct batch sizes;
        otherwise the analytic shape scaled by the observed divergence
        ratio (a single telemetry point fixes scale, not shape); the bare
        analytic model when nothing was observed at all.
        """
        fitted = self.curve(engine, phase)
        if fitted is not None:
            return fitted.predict, "fitted-curve"
        ratio = self.ewma(engine, phase)
        if ratio is not None and ratio > 0.0:
            return (lambda n: analytic_fn(n) * ratio), "scaled-analytic"
        return analytic_fn, "analytic"

    def pending_actions(self) -> List[DriftAlert]:
        """Drain alerts awaiting a re-price (driver calls at burst bounds)."""
        out, self._pending = self._pending, []
        return out

    def sync_cadence(self) -> int:
        """Streaming sync cadence k (drain every k-th boundary).

        1 while drain-sync cost stays within ``SYNC_BUDGET_FRAC`` of the
        burst cost; stretches proportionally (capped) when syncs dominate.
        """
        if not self._sync_ewma or not self._burst_ewma:
            return 1
        budget = SYNC_BUDGET_FRAC * self._burst_ewma
        if budget <= 0.0 or self._sync_ewma <= budget:
            return 1
        k = int(self._sync_ewma / budget) + 1
        return min(k, MAX_SYNC_EVERY)

    # ---- actions ----------------------------------------------------------
    def note_reprice(self, alert: DriftAlert, detail: dict) -> None:
        """Record that the loop acted on ``alert`` and re-arm the detector."""
        st = self._state(alert.engine, alert.phase)
        st.alert_active = False
        st.n_obs = 0          # drift must re-warm against the new price
        tracer = self._tracer
        t = tracer.now() if tracer is not None else 0.0
        event = {"engine": alert.engine, "phase": alert.phase, "t": t,
                 "ewma_ratio": alert.ewma_ratio, **detail}
        self.reprices.append(event)
        if self._registry is not None:
            self._registry.counter("watchdog_reprices").inc()
        if tracer is not None and tracer.enabled:
            tracer.instant("reprice", track="server", cat="watchdog",
                           args=event, t=t)

    # ---- reporting --------------------------------------------------------
    def report(self) -> dict:
        """JSON-safe ``watchdog`` section for the metrics snapshot."""
        streams = {}
        for (engine, phase), st in sorted(self._states.items()):
            fitted = self.curve(engine, phase)
            streams[f"{engine}/{phase}"] = {
                "ewma_ratio": st.ewma,
                "n_obs_since_action": st.n_obs,
                "n_alerts": st.n_alerts,
                "alert_active": st.alert_active,
                "batches_observed": sorted(st.samples),
                "curve": fitted.summary() if fitted is not None else None,
            }
        return {
            "config": {"ewma_alpha": self.ewma_alpha,
                       "drift_gate": self.drift_gate,
                       "warmup": self.warmup,
                       "skip_first": SKIP_FIRST,
                       "sync_budget_frac": SYNC_BUDGET_FRAC},
            "streams": streams,
            "alerts": [a.to_dict() for a in self.alerts],
            "reprices": list(self.reprices),
            "sync_cadence": self.sync_cadence(),
            "sync_cost_ewma_s": self._sync_ewma,
            "burst_cost_ewma_s": self._burst_ewma,
        }




# ---------------------------------------------------------------------------
# Speculative-decoding acceptance (online EWMA + re-decision veto)
# ---------------------------------------------------------------------------
DEFAULT_ACCEPTANCE_REDECIDE_EVERY = 8


class AcceptanceTracker:
    """Online EWMA of the draft's per-token acceptance rate.

    The trade-off analyzer prices speculation on a *prior* (or cached)
    acceptance rate; this tracker watches the rate the run actually
    delivers.  Every ``redecide_every`` rounds past ``warmup`` it calls
    ``decide(alpha)`` — a closure over
    :func:`repro_torch.serving.placement.choose_speculation` — and latches
    ``disabled`` the first time the re-decision says speculation now prices
    worse than plain decode.  The veto is one-way: re-enabling mid-run would
    need the draft caches re-synced for every slot, and a wrongly-disabled
    run merely decodes plain.
    """

    def __init__(self, *, ewma_alpha: float = DEFAULT_EWMA_ALPHA,
                 warmup: int = DEFAULT_WARMUP,
                 redecide_every: int = DEFAULT_ACCEPTANCE_REDECIDE_EVERY,
                 decide: Optional[Callable[[float], object]] = None):
        self.ewma_alpha = ewma_alpha
        self.warmup = warmup
        self.redecide_every = max(int(redecide_every), 1)
        self.decide = decide
        self.ewma: Optional[float] = None
        self.n_rounds = 0
        self.n_proposed = 0
        self.n_accepted = 0
        self.disabled = False
        self.decisions: List[dict] = []

    def observe_round(self, proposed: int, accepted: int) -> None:
        """Feed one speculative round's draft-token tallies."""
        if proposed <= 0:
            return
        r = accepted / proposed
        self.n_rounds += 1
        self.n_proposed += int(proposed)
        self.n_accepted += int(accepted)
        a = self.ewma_alpha
        self.ewma = r if self.ewma is None else (1 - a) * self.ewma + a * r
        if (self.decide is not None and not self.disabled
                and self.n_rounds >= self.warmup
                and self.n_rounds % self.redecide_every == 0):
            decision = self.decide(self.acceptance)
            if decision is not None:
                self.decisions.append(
                    {"round": self.n_rounds,
                     "acceptance": self.acceptance,
                     "use": bool(getattr(decision, "use", True))})
                if not getattr(decision, "use", True):
                    self.disabled = True

    @property
    def acceptance(self) -> float:
        """Best current estimate of the per-token acceptance rate."""
        if self.ewma is not None:
            return self.ewma
        if self.n_proposed > 0:
            return self.n_accepted / self.n_proposed
        return 0.0

    def report(self) -> dict:
        return {"acceptance_ewma": self.ewma,
                "acceptance_cum": (self.n_accepted / self.n_proposed
                                   if self.n_proposed else None),
                "n_rounds": self.n_rounds,
                "n_proposed": self.n_proposed,
                "n_accepted": self.n_accepted,
                "disabled": self.disabled,
                "decisions": list(self.decisions)}


# ---------------------------------------------------------------------------
# SLO attainment (serve --slo-report)
# ---------------------------------------------------------------------------


def request_class(req, boundaries: Tuple[int, int]) -> str:
    """Bucket a request by generation length (short/medium/long)."""
    if req.max_new_tokens <= boundaries[0]:
        return "short"
    if req.max_new_tokens <= boundaries[1]:
        return "medium"
    return "long"


def class_boundaries(requests) -> Tuple[int, int]:
    """Tercile boundaries over the workload's generation lengths."""
    lens = sorted(r.max_new_tokens for r in requests)
    if not lens:
        return (0, 0)
    return (lens[len(lens) // 3], lens[(2 * len(lens)) // 3])


def slo_attainment(requests, *, ttft_slo_s: float,
                   tpot_slo_s: float) -> List[dict]:
    """Per-request-class TTFT/TPOT SLO attainment rows (+ an `all` row)."""
    done = [r for r in requests if r.t_done is not None]
    bounds = class_boundaries(done)
    groups: Dict[str, list] = {"short": [], "medium": [], "long": []}
    for r in done:
        groups[request_class(r, bounds)].append(r)
    rows = []
    for name in ("short", "medium", "long", "all"):
        members = done if name == "all" else groups[name]
        ttfts = [r.ttft for r in members if r.ttft is not None]
        tpots = [r.tpot for r in members if r.tpot is not None]
        rows.append({
            "class": name,
            "n": len(members),
            "gen_len_max": max((r.max_new_tokens for r in members),
                               default=None),
            "ttft_p50_s": (sorted(ttfts)[len(ttfts) // 2] if ttfts else None),
            "tpot_p50_s": (sorted(tpots)[len(tpots) // 2] if tpots else None),
            "ttft_attained": (sum(1 for t in ttfts if t <= ttft_slo_s)
                              / len(ttfts) if ttfts else None),
            "tpot_attained": (sum(1 for t in tpots if t <= tpot_slo_s)
                              / len(tpots) if tpots else None),
        })
    return rows


def format_slo_report(rows: List[dict], *, ttft_slo_s: float,
                      tpot_slo_s: float) -> str:
    """Render the attainment rows as the table ``--slo-report`` prints."""
    def pct(v):
        return "    --" if v is None else f"{100.0 * v:5.1f}%"

    def ms(v):
        return "     --" if v is None else f"{1e3 * v:7.1f}"

    lines = [
        f"SLO attainment (TTFT <= {1e3 * ttft_slo_s:.0f} ms, "
        f"TPOT <= {1e3 * tpot_slo_s:.0f} ms)",
        f"{'class':<8}{'n':>4}{'ttft p50 ms':>13}{'ttft ok':>9}"
        f"{'tpot p50 ms':>13}{'tpot ok':>9}",
    ]
    for row in rows:
        lines.append(
            f"{row['class']:<8}{row['n']:>4}{ms(row['ttft_p50_s']):>13}"
            f"{pct(row['ttft_attained']):>9}{ms(row['tpot_p50_s']):>13}"
            f"{pct(row['tpot_attained']):>9}")
    return "\n".join(lines)
