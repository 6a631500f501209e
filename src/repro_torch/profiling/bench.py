"""Microbenchmark harness: time any buildable engine on any LayerSpec.

The measurement discipline:

* build the engine callable once and make the input and parameters on the
  device first, from an explicit ``torch.Generator``, so set-up and copies
  stay out of the timed region;
* ``warmup`` untimed calls, then ``torch.cuda.synchronize()``;
* ``repeats`` timed calls, each one call between two CUDA events (on the
  CPU, which only the tests ask for, between two ``perf_counter`` reads),
  reduced to **median + IQR** (robust to scheduler noise; a mean would let
  one preempted repeat poison the calibration).

One call between two events is what a compiled plan pays per layer: its
layers run eagerly, one call after another, so a call shorter than the
host's time to issue it costs the host's time there too.

A measurement records everything the calibrator and the measured-pricing
scheduler need: the spec fingerprint, achieved time statistics, FLOPs, and
the (torch version, device name, capability) environment it is valid under.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..core.engines import ExecutionEngine, init_layer_params
from ..core.layer_model import (AttentionSpec, ConvSpec, FCSpec, LayerSpec,
                                MLPSpec, MoESpec, NetworkSpec, NormSpec,
                                PoolSpec, SSMSpec)
from . import cache as cache_lib


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One (layer spec, engine) timing under one environment."""

    layer: str
    kind: str
    engine: str
    batch: int
    dtype: str
    repeats: int
    t_median: float              # seconds
    t_iqr: float                 # interquartile range of the repeats
    t_min: float
    t_mean: float
    flops: int                   # forward FLOPs at `batch`
    fingerprint: str
    torch_version: str
    device_name: str
    capability: str

    @property
    def achieved_flops(self) -> float:
        """Measured FLOP/s (the quantity the calibrator fits)."""
        return self.flops / self.t_median if self.t_median > 0 else 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def dtype_name(dtype: torch.dtype) -> str:
    """"float32", "bfloat16": the names the JAX package's cache uses."""
    return str(dtype).removeprefix("torch.")


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profiling: no CUDA device is available; pass "
                           "device='cpu' to measure on the CPU")
    return device


def make_input(spec: LayerSpec, batch: int = 1, dtype=torch.float32, *,
               device="cuda",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Synthesize the layer's forward input from its declarative tuple,
    drawn from ``generator`` (on its own device) and moved to ``device``."""
    if isinstance(spec, (ConvSpec, NormSpec, PoolSpec)):
        h, w, c = spec.m_i
        shape = (batch, h, w, c)
    elif isinstance(spec, FCSpec):
        shape = (batch,) + tuple(spec.m_i)
    elif isinstance(spec, (AttentionSpec, MLPSpec, MoESpec, SSMSpec)):
        # the decode-step / prefill kinds serving admission prices: a
        # (batch, seq, d_model) activation (seq=1 for decode-step specs)
        shape = (batch, spec.seq, spec.d_model)
    else:
        raise NotImplementedError(
            f"no input synthesizer for {type(spec).__name__}")
    device = _check_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.to(device=device, dtype=dtype)


def _time_calls(fn, x, params, device: torch.device, warmup: int,
                repeats: int) -> np.ndarray:
    """Seconds of each of ``repeats`` calls, after ``warmup`` calls."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn(x, params)
        if device.type == "cpu":
            times = np.empty(repeats)
            for i in range(repeats):
                t0 = time.perf_counter()
                fn(x, params)
                times[i] = time.perf_counter() - t0
            return times
        torch.cuda.synchronize(device)
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(repeats)]
        for start, end in marks:
            start.record()
            fn(x, params)
            end.record()
        torch.cuda.synchronize(device)
    return np.array([s.elapsed_time(e) / 1e3 for s, e in marks])


def time_layer(
    engine: ExecutionEngine,
    spec: LayerSpec,
    *,
    batch: int = 1,
    dtype=torch.float32,
    warmup: int = 2,
    repeats: int = 5,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Measurement:
    """Measure one layer on one buildable engine on ``device`` (set-up
    excluded).  Input and parameters come from ``generator``, by default
    one on ``device`` seeded with 0."""
    if not engine.buildable:
        raise ValueError(f"engine {engine.name} is cost-only; nothing to "
                         "measure (the paper devices live in device_models)")
    if warmup < 1 or repeats < 1:
        raise ValueError("warmup and repeats must both be >= 1")
    device = _check_device(device)
    env = cache_lib.environment(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    fn = engine.build(spec)
    x = make_input(spec, batch, dtype, device=device, generator=generator)
    params = {name: t.to(dtype) for name, t in init_layer_params(
        spec, generator, device=device).items()}
    times = _time_calls(fn, x, params, device, warmup, repeats)

    q25, q50, q75 = np.percentile(times, (25, 50, 75))
    name = dtype_name(dtype)
    return Measurement(
        layer=spec.name, kind=spec.kind, engine=engine.name,
        batch=batch, dtype=name, repeats=repeats,
        t_median=float(q50), t_iqr=float(q75 - q25),
        t_min=float(times.min()), t_mean=float(times.mean()),
        flops=spec.flops(batch),
        fingerprint=cache_lib.fingerprint(spec, batch, name), **env)


def profile_network(
    net: Iterable[LayerSpec] | NetworkSpec,
    engines: Sequence[ExecutionEngine],
    *,
    batch: int = 1,
    dtype=torch.float32,
    warmup: int = 2,
    repeats: int = 5,
    cache: Optional[cache_lib.ProfileCache] = None,
    measure_on_miss: bool = True,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> List[Measurement]:
    """Profile every (layer, buildable engine) pair on ``device``,
    cache-aware.

    Cache hits (same fingerprint, engine, torch version, card) are returned
    without re-measuring; misses are measured and written back to ``cache``
    when ``measure_on_miss`` (otherwise skipped).  ``cache`` must be a view
    for ``device``.
    """
    device = _check_device(device)
    if cache is not None and cache.device != device:
        raise ValueError(f"profile_network on {device} with a cache for "
                         f"{cache.device}")
    specs = tuple(net)                   # net may be a one-shot iterable
    name = dtype_name(dtype)
    out: List[Measurement] = []
    for engine in engines:
        if not engine.buildable:
            continue
        for spec in specs:
            if not engine.supports(spec):
                continue
            if cache is not None:
                hit = cache.get(spec, engine.name, batch=batch, dtype=name)
                if hit is not None:
                    out.append(Measurement.from_dict(hit))
                    continue
            if not measure_on_miss:
                continue
            try:
                m = time_layer(engine, spec, batch=batch, dtype=dtype,
                               warmup=warmup, repeats=repeats, device=device,
                               generator=generator)
            except NotImplementedError:
                # a kind an engine lists but cannot build yet: skip the
                # pair rather than abort the whole sweep
                continue
            if cache is not None:
                cache.put(m)
            out.append(m)
    return out
