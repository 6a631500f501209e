"""Measured speculative-decoding acceptance rates, persisted per pair.

``serving.placement.choose_speculation`` prices speculation on a per-token
acceptance rate; a *prior* is the one number in that formula the device
models cannot supply — it depends on how well the draft imitates the target
on the served traffic.  This module closes that gap the way
:mod:`~repro_torch.profiling.transfer` closed the link-bandwidth one: the
rate a serve run measured is kept in the profile cache (environment-keyed,
so a rate measured on one card or under one torch never prices another),
and the next run prices its speculation decision on it instead of the prior.

The cache entry is a full :data:`~repro_torch.profiling.cache.
REQUIRED_FIELDS` measurement (``kind="acceptance"``, ``t_*`` = 0 —
acceptance is a rate, not a time; ``flops=0``; the cache's environment
fields) plus the derived ``acceptance_rate`` and the (draft, target) pair
labels, so ``python -m repro_torch.profiling.cache --validate`` accepts it
and :func:`cached_acceptance` finds it again.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import cache as cache_lib

# engine name acceptance measurements are filed under in the profile cache
ACCEPTANCE_ENGINE = "speculative"
# provenance tag (ProfileCache.measurements(source=...))
ACCEPTANCE_SOURCE = "acceptance-measurement"


@dataclasses.dataclass(frozen=True)
class AcceptanceSpec:
    """Declarative spec of one measured (draft, target) pairing (a
    dataclass so :func:`repro_torch.profiling.cache.fingerprint` hashes it
    like any layer spec)."""
    name: str
    draft: str
    target: str
    k: int


def acceptance_measurement(*, draft_arch: str, target_arch: str, k: int,
                           n_proposed: int, n_accepted: int, n_rounds: int,
                           device="cuda") -> dict:
    """Build a profile-cache measurement dict from a run's tallies, filed
    under the environment of ``device`` (the card the run served on)."""
    if n_proposed <= 0:
        raise ValueError("acceptance needs at least one proposed token")
    spec = AcceptanceSpec(name=f"accept:{draft_arch}->{target_arch}",
                          draft=draft_arch, target=target_arch, k=int(k))
    return {
        "layer": spec.name, "kind": "acceptance",
        "engine": ACCEPTANCE_ENGINE, "batch": 1, "dtype": "int32",
        "repeats": int(n_rounds), "t_median": 0.0, "t_iqr": 0.0,
        "t_min": 0.0, "t_mean": 0.0, "flops": 0,
        "fingerprint": cache_lib.fingerprint(spec, 1, "int32"),
        **cache_lib.environment(device),
        # derived + provenance (extra fields survive cache validation)
        "acceptance_rate": n_accepted / n_proposed,
        "n_proposed": int(n_proposed), "n_accepted": int(n_accepted),
        "n_rounds": int(n_rounds), "k": int(k),
        "draft": draft_arch, "target": target_arch,
        "source": ACCEPTANCE_SOURCE,
    }


def record_acceptance(cache: cache_lib.ProfileCache, *, draft_arch: str,
                      target_arch: str, k: int, n_proposed: int,
                      n_accepted: int, n_rounds: int) -> dict:
    """Store a run's measured acceptance in ``cache``, under the cache's
    own device (not saved to disk here — the caller owns persistence)."""
    m = acceptance_measurement(draft_arch=draft_arch,
                               target_arch=target_arch, k=k,
                               n_proposed=n_proposed,
                               n_accepted=n_accepted, n_rounds=n_rounds,
                               device=cache.device)
    cache.put(m)
    return m


def cached_acceptance(cache: cache_lib.ProfileCache, *, draft_arch: str,
                      target_arch: str) -> Optional[float]:
    """The measured acceptance rate for this (draft, target) pair in the
    cache's environment, or None when the cache holds no usable
    measurement.  The largest-sample measurement wins (most proposed tokens
    — the best steady-state estimate)."""
    best = None
    for m in cache.measurements(engine=ACCEPTANCE_ENGINE,
                                source=ACCEPTANCE_SOURCE):
        if m.get("draft") != draft_arch or m.get("target") != target_arch:
            continue
        rate = m.get("acceptance_rate")
        if not isinstance(rate, (int, float)) or not 0.0 <= rate <= 1.0:
            continue
        if best is None or m.get("n_proposed", 0) > best.get("n_proposed", 0):
            best = m
    return float(best["acceptance_rate"]) if best else None
