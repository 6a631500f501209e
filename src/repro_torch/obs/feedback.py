"""Telemetry feedback: serving burst timings -> profile-cache entries (the
JAX package's ``obs/feedback.py``, writing into the port's own
:class:`~repro_torch.profiling.cache.ProfileCache`).

Every decode burst the serving loop dispatches is a free measurement of the
decode network at ``batch = n_active`` — the quantity ``ContinuousBatcher``
prices at admission and ``schedule(..., price="measured")`` looks up.  This
module turns those observations into
:class:`~repro_torch.profiling.bench.Measurement`-shaped cache entries so
``MeasuredPricer`` learns from served traffic without a dedicated profiling
run.

Apportioning: a burst observes the *whole* decode step, but the cache is
keyed per layer spec.  The observed per-step time is split across
:func:`~repro_torch.serving.batcher.decode_network_spec`'s layers by FLOP
share — the weighting the analytic cost model uses — so per-layer entries
sum back to the observed step and each carries a correct
``achieved_flops``.  Zero-FLOP layers (embedding gather) are skipped.

Keying: entries are fingerprinted with the profile cache's own
:func:`~repro_torch.profiling.cache.fingerprint` (spec + batch + the served
compute dtype) under the environment (torch version, device name,
capability) of the device the bursts ran on, and ``engine="torch"`` — the
port's counterpart of the JAX package's ``"xla"``, the engine that priced
the burst — so lookups hit if and only if they ask for what serving ran.
A ``"source": "serving-telemetry"`` field distinguishes fed points from
bench-harness ones.

Timing hygiene: a burst is queued on the card without a sync, so the loop
syncs the engine before stamping the burst end — the observation is the
card's time, not the host's enqueue time.  The sync only waits, so feeding
the cache keeps every output bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["TelemetryFeedback"]


class TelemetryFeedback:
    """Accumulates per-burst step timings; flushes cache entries."""

    def __init__(self, cfg, *, kv_len: int, engine: str = "torch",
                 dtype: str = "float32", device="cuda"):
        """``kv_len`` should be the KV pool's ``max_seq`` — the length
        admission prices with (``decode_network_spec(cfg, pool.max_seq)``),
        so fed entries answer the same lookups pricing makes.  ``dtype`` is
        the served compute dtype's name (``serve()`` passes it; the default
        is the JAX package's).  ``device`` is the one the bursts run on:
        its environment keys the entries."""
        self.cfg = cfg
        self.kv_len = int(kv_len)
        self.engine = engine
        self.dtype = dtype
        self.device = device
        # batch (= tokens per step) -> observed per-step seconds
        self._step_s: Dict[int, List[float]] = {}
        self.n_bursts = 0

    def observe_burst(self, n_tokens: int, steps: float,
                      elapsed_s: float) -> None:
        """One synced decode burst: ``steps`` engine iterations carrying
        ``n_tokens`` tokens each took ``elapsed_s`` of wall time."""
        if n_tokens <= 0 or steps <= 0 or elapsed_s <= 0:
            return
        self._step_s.setdefault(int(n_tokens), []).append(elapsed_s / steps)
        self.n_bursts += 1

    @property
    def batches(self) -> List[int]:
        """Token-per-step batch sizes observed so far."""
        return sorted(self._step_s)

    def measurements(self) -> List[dict]:
        """Cache-entry dicts for every observed batch size."""
        # lazy imports: keep repro_torch.obs importable without serving
        from ..profiling import cache as cache_lib
        from ..serving.batcher import decode_network_spec

        net = decode_network_spec(self.cfg, self.kv_len)
        env = cache_lib.environment(self.device)
        out: List[dict] = []
        for batch, times in sorted(self._step_s.items()):
            xs = np.asarray(times)
            q25, q50, q75 = np.percentile(xs, (25, 50, 75))
            flops = [l.flops(batch) for l in net]
            total = sum(flops)
            if total <= 0:
                continue
            for spec, fl in zip(net, flops):
                if fl <= 0:
                    continue             # gather layers: nothing to price
                share = fl / total
                if float(q50) * share <= 0.0:
                    # a tiny FLOP share can underflow the apportioned time
                    # to 0.0; a 0-cost entry would price the layer as free
                    continue
                out.append({
                    "layer": spec.name, "kind": spec.kind,
                    "engine": self.engine, "batch": int(batch),
                    "dtype": self.dtype, "repeats": len(times),
                    "t_median": float(q50) * share,
                    "t_iqr": float(q75 - q25) * share,
                    "t_min": float(xs.min()) * share,
                    "t_mean": float(xs.mean()) * share,
                    "flops": int(fl),
                    "fingerprint": cache_lib.fingerprint(
                        spec, batch, self.dtype),
                    **env,
                    "source": "serving-telemetry",
                })
        return out

    def flush(self, cache) -> int:
        """Write all accumulated measurements into ``cache`` (a
        :class:`~repro_torch.profiling.cache.ProfileCache`).  Returns the
        number of entries written.  Does not save — the caller owns
        persistence."""
        ms = self.measurements()
        for m in ms:
            cache.put(m)
        return len(ms)
