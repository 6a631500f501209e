"""Measured inter-device link bandwidth for hand-off pricing.

``core.cost_model.transfer_cost`` *assumes* the hand-off link when no
``link_bw`` is given: it bounds the transfer by the slower endpoint's memory
bandwidth, a datasheet number, not a measurement.  This module measures an
actual copy of a representative page batch between the two phase devices
and keeps the result in the profile cache (environment-keyed, so a cache
written on one card or under one torch never prices another), as the JAX
package's ``profiling/transfer.py`` does with ``jax.device_put``.

The probe is a real copy: ``src.to(dst)`` returns ``src`` itself when the
two devices are equal, so the destination is allocated first and the
source ``copy_``'d into it, and each timed copy is synchronized before its
timer stops.  Same-device copies are measured too; they give the honest
price of a colocated hand-off.

The cache entry is a full :data:`~repro_torch.profiling.cache.
REQUIRED_FIELDS` measurement (``kind="transfer"``, ``t_*`` = seconds for the
timed copy, ``flops=0``, the port's environment fields) plus the derived
``link_bw`` (bytes/s), the endpoint labels and ``backend`` (the device
type), so ``python -m repro_torch.profiling.cache --validate`` accepts it
and :func:`cached_link_bw` finds it again next run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import cache as cache_lib

# engine name the link measurements are filed under in the profile cache
LINK_ENGINE = "interconnect"
# provenance tag (ProfileCache.measurements(source=...))
LINK_SOURCE = "link-calibration"

# default representative payload: 64 KV pages of a smallish model — big
# enough to amortize the launch, small enough to measure at startup
DEFAULT_LINK_PROBE_BYTES = 1 << 22          # 4 MiB


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Declarative spec of one measured device-to-device copy (a dataclass
    so :func:`repro_torch.profiling.cache.fingerprint` hashes it like any
    layer spec)."""
    name: str
    src: str                     # device label, e.g. "cuda:0"
    dst: str
    n_bytes: int


def _sync(*devices: torch.device) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_link_bandwidth(src_dev, dst_dev, *, n_bytes: int =
                           DEFAULT_LINK_PROBE_BYTES, warmup: int = 1,
                           repeats: int = 5) -> dict:
    """Time a copy of an ``n_bytes`` buffer from ``src_dev`` into new
    storage on ``dst_dev`` and return a profile-cache measurement dict.

    The source is made (and synced) on ``src_dev`` and the destination
    allocated before timing; every timed copy is synchronized on both
    devices before its timer stops, and the repeats reduce to median + IQR.
    """
    from ..launch.mesh import device_label

    src_dev, dst_dev = torch.device(src_dev), torch.device(dst_dev)
    n_f32 = max(1, n_bytes // 4)
    src_label = device_label(src_dev)
    dst_label = device_label(dst_dev)
    x = torch.zeros((n_f32,), dtype=torch.float32, device=src_dev)
    y = torch.empty((n_f32,), dtype=torch.float32, device=dst_dev)
    _sync(src_dev, dst_dev)
    for _ in range(max(0, warmup)):
        y.copy_(x)
        _sync(src_dev, dst_dev)
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        y.copy_(x)
        _sync(src_dev, dst_dev)
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    t_median = float(np.median(arr))
    q1, q3 = np.percentile(arr, [25, 75])
    spec = LinkSpec(name=f"link:{src_label}->{dst_label}",
                    src=src_label, dst=dst_label, n_bytes=4 * n_f32)
    env = cache_lib.environment(dst_dev)
    return {
        "layer": spec.name, "kind": "transfer", "engine": LINK_ENGINE,
        "batch": 1, "dtype": "float32", "repeats": int(repeats),
        "t_median": t_median, "t_iqr": float(q3 - q1),
        "t_min": float(arr.min()), "t_mean": float(arr.mean()),
        "flops": 0,
        "fingerprint": cache_lib.fingerprint(spec, 1, "float32"),
        **env, "backend": dst_dev.type,
        # derived + provenance (extra fields survive cache validation)
        "link_bw": (4 * n_f32) / t_median if t_median > 0 else float("inf"),
        "n_bytes": 4 * n_f32, "src": src_label, "dst": dst_label,
        "source": LINK_SOURCE,
    }


def record_link_bw(cache: cache_lib.ProfileCache, src_dev, dst_dev, *,
                   n_bytes: int = DEFAULT_LINK_PROBE_BYTES,
                   repeats: int = 5) -> dict:
    """Measure the ``src -> dst`` link and store it in ``cache`` (not
    saved to disk here — the caller owns persistence)."""
    m = measure_link_bandwidth(src_dev, dst_dev, n_bytes=n_bytes,
                               repeats=repeats)
    cache.put(m)
    return m


def cached_link_bw(cache: cache_lib.ProfileCache, *,
                   src: Optional[str] = None,
                   dst: Optional[str] = None) -> Optional[float]:
    """The measured link bandwidth (bytes/s) for the cache's environment,
    or None when the cache holds no usable link measurement.

    ``src``/``dst`` filter on device labels; without them the
    largest-payload measurement wins (the most amortized probe is the best
    steady-state estimate).
    """
    best = None
    for m in cache.measurements(engine=LINK_ENGINE, source=LINK_SOURCE):
        if src is not None and m.get("src") != src:
            continue
        if dst is not None and m.get("dst") != dst:
            continue
        bw = m.get("link_bw")
        if not isinstance(bw, (int, float)) or bw <= 0:
            continue
        if best is None or m.get("n_bytes", 0) > best.get("n_bytes", 0):
            best = m
    return float(best["link_bw"]) if best else None
