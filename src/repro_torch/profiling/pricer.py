"""Measured pricing for the scheduler: profile-then-offload.

CNNLab "at runtime leverages the trade-offs between GPU and FPGA *before
offloading* the tasks" — the decision input is a measurement, not a model.
:class:`MeasuredPricer` is that runtime flow for our scheduler: asked to
price a (layer, engine) candidate it consults the profile cache, measures
on miss (warmup + repeats via the bench harness), persists the new
measurement, and returns a :class:`~repro_torch.core.cost_model.CostBreakdown`
whose time term *is* the measured median.  ``schedule(...,
price="measured")`` plugs it in; engines the pricer cannot measure
(cost-only paper devices, backward passes, multi-chip plans) silently fall
back to the analytic cost model so planning always completes.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.cost_model import CostBreakdown
from ..core.engines import ExecutionEngine
from ..core.layer_model import LayerSpec
from . import bench
from .cache import DEFAULT_CACHE_PATH, ProfileCache

_DTYPE_FOR_BYTES = {4: torch.float32, 2: torch.bfloat16}


class MeasuredPricer:
    """Callable the scheduler consults before falling back to analytic."""

    def __init__(self, cache: Optional[ProfileCache] = None, *,
                 measure_on_miss: bool = True, warmup: int = 2,
                 repeats: int = 5, dtype=None, autosave: bool = True,
                 device="cuda"):
        """``dtype=None`` (default) derives the measurement dtype from the
        schedule's ``dtype_bytes`` so a bf16-priced plan gets bf16 timings;
        pass an explicit dtype to pin it.  Measurements run on ``device``,
        whose view ``cache`` must be (default: the cache at
        ``DEFAULT_CACHE_PATH``)."""
        device = torch.device(device)
        if cache is None:
            cache = ProfileCache.load(DEFAULT_CACHE_PATH, strict=False,
                                      device=device)
        if cache.device != device:
            raise ValueError(f"MeasuredPricer on {device} with a cache for "
                             f"{cache.device}")
        self.cache = cache
        self.device = device
        self.measure_on_miss = measure_on_miss
        self.warmup = warmup
        self.repeats = repeats
        self.dtype = dtype
        self.autosave = autosave
        self.hits = 0
        self.misses = 0

    def measurement_for(self, spec: LayerSpec, engine: ExecutionEngine, *,
                        batch: int = 1,
                        dtype=torch.float32) -> Optional[bench.Measurement]:
        """Cache-or-measure.  None when the pair is unmeasurable."""
        if not engine.buildable:
            return None
        hit = self.cache.get(spec, engine.name, batch=batch,
                             dtype=bench.dtype_name(dtype))
        # a degenerate 0-cost entry would price the layer as free and poison
        # every achieved-FLOPs fit downstream — treat it as a miss, not a hit
        if hit is not None and float(hit.get("t_median", 0.0)) > 0.0:
            self.hits += 1
            return bench.Measurement.from_dict(hit)
        if not self.measure_on_miss:
            return None
        try:
            m = bench.time_layer(engine, spec, batch=batch, dtype=dtype,
                                 warmup=self.warmup, repeats=self.repeats,
                                 device=self.device)
        except NotImplementedError:
            return None
        self.misses += 1
        self.cache.put(m)
        if self.autosave:
            self.cache.save()
        return m

    def price(self, spec: LayerSpec, engine: ExecutionEngine, *,
              batch: int = 1, dtype_bytes: int = 4, n_chips: int = 1,
              direction: str = "fwd") -> Optional[CostBreakdown]:
        """Measured CostBreakdown, or None -> caller uses analytic.

        Only forward single-device execution is measurable on this harness;
        the power term stays the device model's (no meter read here), so
        energy/EDP objectives mix measured time with modeled watts.
        """
        if direction != "fwd" or n_chips != 1:
            return None
        dtype = self.dtype or _DTYPE_FOR_BYTES.get(dtype_bytes)
        if dtype is None:                # no measurable dtype at this width
            return None
        m = self.measurement_for(spec, engine, batch=batch, dtype=dtype)
        if m is None or m.t_median <= 0:
            return None
        return CostBreakdown(
            layer=spec.name, kind=spec.kind, device=engine.device.name,
            flops=m.flops,
            bytes_moved=(spec.activation_bytes(batch, dtype_bytes)
                         + spec.param_bytes(dtype_bytes)),
            collective_bytes=0,
            t_compute=m.t_median, t_memory=0.0, t_collective=0.0,
            power_w=engine.device.watts(spec.kind, direction))
