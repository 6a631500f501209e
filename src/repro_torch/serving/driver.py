"""Open-loop driver for the serving loop + streaming output channel (the JAX
package's ``serving/driver.py``).

The driver owns the open-loop scaffolding — drain the arrival stream into
the queue, fast-forward the skew clock across idle gaps, cap bursts while
arrivals are pending, account ``max_steps``, scan completions and aggregate
metrics — and the loop provides a small hook surface:

  ``in_flight()``            any admitted work besides the queue
  ``admit(queue, now, m)``   admission + binding
  ``runnable()``             any engine has an active slot to burst
  ``backlogged(queue)``      loop-specific extra throttle signal
  ``dispatch(throttle, budget)``  burst the engine, return steps dispatched
  ``sample(m)``              append pool occupancy/utilization samples
  ``scan(clock, m, sink)``   completion scan + stream emission

Streaming sits on top of the driver: pass ``on_delta`` and the completion
scan syncs each engine's device chain at the burst boundary
(``SlotEngine.pull_outputs``) and emits ``StreamDelta(rid, tokens)`` for
every newly host-readable sample, instead of only pulling a slot's row at
completion.  This is also where the first-token metric gets honest:

  * ``Request.t_first_token`` is stamped when the first sample is actually
    readable on the host — at the burst-boundary sync under streaming, at
    the completion pull otherwise (matching the static server, which also
    only surfaces tokens at batch end).  TTFT therefore measures delivered
    tokens, not dispatch latency.
  * ``Request.t_first_dispatch`` keeps the old stamp (the burst containing
    the first sample has been *dispatched*, CNNLab's per-stage enqueue
    time), so ``ttft - ttft_dispatch`` quantifies the gap the old metric
    hid.  ``ttft_dispatch <= ttft`` holds for every request.

Streaming costs one host sync per burst boundary; the completion-pull path
keeps the fully-pipelined async dispatch chain.  Scheduling is identical
either way — streamed deltas concatenate to exactly the completion-pull
rows.

Observability: the driver reads the loop's
:class:`~repro_torch.obs.Observability` bundle.  It installs the skew clock
into the tracer at run start (every trace timestamp lives on the
offered-load timeline the metrics use), refreshes the registry's gauges each
iteration (KV occupancy, queue depth, in-flight slots, admission totals) and
samples them into the registry's time series, and mirrors the same values
as counter tracks when tracing is on.  ``ServeMetrics`` mirrors its per-request observations into
the registry's histograms so one snapshot carries everything.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import NullTracer, Observability, default_clock
from .request import Request

# with arrivals pending, bursts stay short so admission latency is bounded;
# otherwise a burst runs to the next
# completion boundary
BURST_CAP_PENDING = 4


def _percentile(xs: List[float], q: float) -> Optional[float]:
    """None (JSON null) when there are no observations — never NaN, which
    json.dump writes as a non-standard token strict parsers reject."""
    return float(np.percentile(np.asarray(xs), q)) if xs else None


@dataclasses.dataclass
class ServeMetrics:
    n_done: int = 0
    n_dropped: int = 0
    n_steps: int = 0
    tokens_out: int = 0
    tokens_in: int = 0
    tokens_streamed: int = 0            # delivered incrementally (streaming)
    n_stream_deltas: int = 0            # StreamDelta emissions
    elapsed_s: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    ttft_dispatch_s: List[float] = dataclasses.field(default_factory=list)
    tpot_s: List[float] = dataclasses.field(default_factory=list)
    latency_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: List[float] = dataclasses.field(default_factory=list)
    utilization: List[float] = dataclasses.field(default_factory=list)
    # optional obs.MetricsRegistry: per-request observations mirror into
    # its histograms/counters so the registry snapshot carries the same
    # distributions this summary reduces
    registry: Optional[object] = None

    def observe(self, req: Request) -> None:
        self.n_done += 1
        self.tokens_out += len(req.output)
        self.tokens_in += req.prompt_len
        if req.ttft is not None:
            self.ttft_s.append(req.ttft)
        if req.ttft_dispatch is not None:
            self.ttft_dispatch_s.append(req.ttft_dispatch)
        if req.tpot is not None:
            self.tpot_s.append(req.tpot)
        if req.t_done is not None:
            self.latency_s.append(req.t_done - req.arrival)
        reg = self.registry
        if reg is not None:
            reg.counter("requests_done").inc()
            reg.counter("tokens_out").inc(len(req.output))
            reg.counter("tokens_in").inc(req.prompt_len)
            if req.ttft is not None:
                reg.histogram("ttft_s").observe(req.ttft)
            if req.tpot is not None:
                reg.histogram("tpot_s").observe(req.tpot)
            if req.t_done is not None:
                reg.histogram("latency_s").observe(req.t_done - req.arrival)

    def drop(self, n: int = 1) -> None:
        self.n_dropped += n
        if self.registry is not None:
            self.registry.counter("requests_dropped").inc(n)

    def summary(self) -> Dict[str, Optional[float]]:
        dt = max(self.elapsed_s, 1e-9)
        return {
            "requests_done": self.n_done,
            "requests_dropped": self.n_dropped,
            "steps": self.n_steps,
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "tokens_streamed": self.tokens_streamed,
            "stream_deltas": self.n_stream_deltas,
            "elapsed_s": self.elapsed_s,
            "tok_per_s": self.tokens_out / dt,
            "req_per_s": self.n_done / dt,
            "ttft_p50_s": _percentile(self.ttft_s, 50),
            "ttft_p99_s": _percentile(self.ttft_s, 99),
            "ttft_dispatch_p50_s": _percentile(self.ttft_dispatch_s, 50),
            "ttft_dispatch_p99_s": _percentile(self.ttft_dispatch_s, 99),
            "tpot_p50_s": _percentile(self.tpot_s, 50),
            "tpot_p99_s": _percentile(self.tpot_s, 99),
            "latency_p50_s": _percentile(self.latency_s, 50),
            "latency_p99_s": _percentile(self.latency_s, 99),
            "kv_occupancy_mean": (float(np.mean(self.occupancy))
                                  if self.occupancy else 0.0),
            "kv_utilization_mean": (float(np.mean(self.utilization))
                                    if self.utilization else 0.0),
        }


@dataclasses.dataclass
class StreamDelta:
    """One incremental output emission: `tokens` became host-readable for
    request `rid` at time `t` (offered-load timeline).  ``done`` marks the
    request's final delta (tokens may be empty if everything already
    streamed at an earlier burst boundary)."""

    rid: int
    tokens: List[int]
    t: float
    done: bool = False


class TokenSink:
    """Output channel shared by the loops: incremental (streaming) or
    completion-pull delivery, plus the honest first-token stamping.

    ``drain(engine, clock)`` is the burst-boundary side: it syncs the
    engine's per-slot output buffer (one host sync for the whole engine) and
    emits every newly readable sample as a delta.  ``finish(req, row, t)``
    is the completion side: it installs the request's final output row and,
    under streaming, emits the tail delta with ``done=True``.
    """

    def __init__(self, metrics: ServeMetrics,
                 on_delta: Optional[Callable[[StreamDelta], None]] = None,
                 tracer=None, watchdog=None):
        self.metrics = metrics
        self.on_delta = on_delta
        self.tracer = tracer if tracer is not None else NullTracer()
        self.watchdog = watchdog
        # sync cadence: drain (device sync + delta emission) only every
        # k-th boundary per engine.  1 = every boundary; the driver
        # stretches it from the watchdog's sync-cost pressure
        self.sync_every = 1
        self._boundaries: Dict[str, int] = {}   # per-engine boundary count

    @property
    def streaming(self) -> bool:
        return self.on_delta is not None

    def drain(self, engine, clock: Callable[[], float]) -> None:
        """Sync `engine`'s outputs at the burst boundary and emit deltas."""
        if self.on_delta is None:
            return                       # completion-pull: keep async chain
        n = self._boundaries.get(engine.name, 0) + 1
        self._boundaries[engine.name] = n
        if n % max(self.sync_every, 1) != 0:
            return                       # skipped boundary: tokens ride the
            #                              next drain (or the finish() tail)
        h = (self.tracer.begin("sync", track=f"engine:{engine.name}",
                               cat="engine", args={"kind": "drain"})
             if self.tracer.enabled else None)
        t0 = self.tracer.now() if self.watchdog is not None else 0.0
        rows = engine.pull_outputs()     # host sync: burst results land
        if self.watchdog is not None:
            self.watchdog.observe_sync(self.tracer.now() - t0)
        if h is not None:
            self.tracer.end(h)
        t = clock()                      # stamped AFTER materialization
        for s, req in enumerate(engine.slots):
            if req is not None:
                self._emit(req, rows[s], req.samples_ready, t, done=False)

    def finish(self, req: Request, row: np.ndarray, t: float) -> None:
        """Completion pull: install the final output row (and stream the
        tail).  `row` is already trimmed to ``max_new_tokens``."""
        req.output = row.tolist()
        if self.on_delta is not None:
            self._emit(req, row, req.max_new_tokens, t, done=True)
        if req.t_first_token is None:
            # completion-pull delivery: the first token became host-visible
            # just now, with the rest of the row
            req.t_first_token = t
            self._first_token_instant(req, t)

    def _first_token_instant(self, req: Request, t: float) -> None:
        if self.tracer.enabled:
            self.tracer.instant("first_token", track="requests", tid=req.rid,
                                cat="request", t=t,
                                args={"ttft_s": req.ttft,
                                      "ttft_dispatch_s": req.ttft_dispatch})

    def _emit(self, req: Request, row: np.ndarray, n_ready: int, t: float,
              done: bool) -> None:
        new = ([] if n_ready <= req.n_streamed
               else [int(x) for x in row[req.n_streamed:n_ready]])
        if not new and not done:
            return
        if new and req.t_first_token is None:
            req.t_first_token = t        # first sample host-visible
            self._first_token_instant(req, t)
        req.n_streamed = max(req.n_streamed, n_ready)
        self.metrics.tokens_streamed += len(new)
        self.metrics.n_stream_deltas += 1
        self.on_delta(StreamDelta(rid=req.rid, tokens=new, t=t, done=done))


def burst_size(remaining: int, *, throttle: bool,
               budget: Optional[int]) -> int:
    """Pending-aware burst capping + ``max_steps`` accounting (the one
    shared implementation): run to the next completion boundary
    (`remaining`), capped while arrivals/hand-offs wait, capped at the
    remaining step budget."""
    burst = remaining
    if throttle:
        burst = min(burst, BURST_CAP_PENDING)
    if budget is not None:
        burst = min(burst, max(budget, 0))
    return burst


def sample_pools(pools) -> tuple:
    """Aggregate (occupancy, utilization) over one or more KV pools.

    Pools can differ in capacity, so the means are weighted: occupancy by
    each pool's ``total_blocks`` (block-weighted pressure == total allocated
    / total capacity) and utilization by each pool's allocated-block token
    capacity (written / allocated capacity).  With one pool this reduces to
    ``pool.occupancy(), pool.utilization()`` exactly.
    """
    total = sum(p.total_blocks for p in pools)
    alloc = sum(p.allocated_block_count for p in pools)
    occupancy = alloc / total if total else 0.0
    cap = sum(p.allocated_block_count * p.block_size for p in pools)
    written = sum(p.written_tokens for p in pools)
    utilization = written / cap if cap else 0.0
    return occupancy, utilization


class OpenLoopDriver:
    """The shared open-loop serving driver.

    Owns the arrival drain, the idle fast-forward skew clock, the
    throttle/budget plumbing into :func:`burst_size`, the per-iteration
    metric sampling and the run-level metrics; the loop owns the engines.

    Invariants: all time comes from the injected ``now_fn`` — the driver
    installs the derived skew clock into the tracer at run start, so every
    metric stamp and trace timestamp lives on one timeline and tests can
    drive the whole loop on a virtual clock (no hidden wall-time reads).
    Scheduling decisions (admission order, burst sizes, throttles,
    re-prices) affect only timing: per-request greedy outputs depend on
    the prompt and the model alone, streamed deltas concatenate to exactly
    the completion-pull rows, and ``ttft_dispatch <= ttft`` holds for
    every request.
    """

    def __init__(self, loop):
        self.loop = loop
        self.obs: Observability = (getattr(loop, "obs", None)
                                   or Observability())

    def run(self, requests: List[Request], *,
            now_fn: Callable[[], float] = default_clock,
            max_steps: Optional[int] = None,
            on_delta: Optional[Callable[[StreamDelta], None]] = None
            ) -> ServeMetrics:
        """Serve `requests` (an arrival-stamped open-loop stream) to
        completion; returns the aggregate metrics.  With ``on_delta`` the
        run streams: every burst boundary syncs the device chain and emits
        newly readable ``(rid, tokens)`` deltas."""
        loop = self.loop
        obs = self.obs
        metrics = ServeMetrics(registry=obs.registry)
        sink = TokenSink(metrics, on_delta, tracer=obs.tracer,
                         watchdog=obs.watchdog)
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        queue: List[Request] = []
        loop.start_run()
        t0 = now_fn()
        skew = 0.0                       # idle fast-forward (see below)
        clock = lambda: now_fn() - t0 + skew
        # every trace timestamp shares the metrics' offered-load timeline
        obs.tracer.set_clock(clock)

        while pending or queue or loop.in_flight():
            now = clock()
            # open-loop arrivals: everything whose arrival time has passed
            # joins the queue
            while pending and pending[0].arrival <= now:
                queue.append(pending.pop(0))
            if not queue and not loop.in_flight():
                # fully idle with the next arrival in the future: fast-
                # forward the clock to it instead of busy-waiting, so
                # timestamps stay on the offered-load timeline (TTFT and
                # latency remain >= 0)
                skew += pending[0].arrival - now
                continue
            loop.admit(queue, now, metrics)
            if not loop.runnable():
                continue                 # nothing admissible (pool pressure)
            throttle = bool(pending) or loop.backlogged(queue)
            budget = (None if max_steps is None
                      else max_steps - metrics.n_steps)
            metrics.n_steps += loop.dispatch(throttle, budget)
            loop.sample(metrics)
            loop.scan(clock, metrics, sink)
            self._act_on_watchdog(sink)
            self._observe_iteration(metrics, queue, pending, clock())
            if max_steps is not None and metrics.n_steps >= max_steps:
                break
        metrics.elapsed_s = clock()
        return metrics

    def _act_on_watchdog(self, sink: TokenSink) -> None:
        """Burst-boundary watchdog hook: hand pending drift alerts to the
        loop's ``on_drift`` action leg (admission re-pricing) and apply the
        current sync-cadence advice to the streaming sink.  All of it is
        scheduling and pricing policy — per-request greedy outputs are
        schedule-independent, so acting never changes them."""
        wd = self.obs.watchdog
        if wd is None:
            return
        on_drift = getattr(self.loop, "on_drift", None)
        if on_drift is not None:
            for alert in wd.pending_actions():
                on_drift(alert, wd)
        sink.sync_every = wd.sync_cadence()

    def _observe_iteration(self, metrics: ServeMetrics, queue: List[Request],
                           pending: List[Request], now: float) -> None:
        """Refresh the registry's gauges from this iteration's state and
        sample them into the time series (+ Perfetto counter tracks)."""
        loop, reg = self.loop, self.obs.registry
        occ = metrics.occupancy[-1] if metrics.occupancy else 0.0
        util = metrics.utilization[-1] if metrics.utilization else 0.0
        in_flight = loop.n_active
        reg.gauge("kv_occupancy").set(occ)
        reg.gauge("kv_utilization").set(util)
        reg.gauge("queue_depth").set(len(queue))
        reg.gauge("pending_arrivals").set(len(pending))
        reg.gauge("slots_in_flight").set(in_flight)
        batchers = loop.batchers
        reg.gauge("admitted_total").set(sum(b.n_admitted for b in batchers))
        reg.gauge("rejected_total").set(sum(b.n_rejected for b in batchers))
        reg.gauge("deferred_total").set(
            sum(b.n_deferred for b in batchers))
        reg.sample(now)
        tracer = self.obs.tracer
        if tracer.enabled:
            tracer.counter("kv", {"occupancy": occ, "utilization": util},
                           track="server", t=now)
            tracer.counter("load", {"queue_depth": len(queue),
                                    "pending_arrivals": len(pending),
                                    "slots_in_flight": in_flight},
                           track="server", t=now)
