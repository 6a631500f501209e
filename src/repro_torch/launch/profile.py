"""Profiling CLI: measure engines, calibrate device models, compare plans.

    PYTHONPATH=src python -m repro_torch.launch.profile --net alexnet-full \
        --batch 64

The paper's runtime flow in one command: microbenchmark every buildable
engine on every layer of the chosen network (cache-on-hit,
measure-on-miss), persist the profile cache, fit calibrated device models
and print the before/after prediction error, then run the DSE twice —
analytic vs measured pricing — and show what the measurements changed.

Runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` measures the plain versions on the CPU.  ``--net tiny`` is
a two-layer spec for smoke runs.
"""
from __future__ import annotations

import argparse

import torch

from ..core import engines as engines_lib
from ..core import scheduler
from ..core.layer_model import (ConvSpec, FCSpec, NetworkSpec, alexnet_spec,
                                alexnet_full_spec)
from ..profiling import (DEFAULT_CACHE_PATH, MeasuredPricer, ProfileCache,
                         calibration_report, profile_network)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tiny_net() -> NetworkSpec:
    """Two tiny layers (one conv, one fc) — the smoke workload."""
    return NetworkSpec("tiny", (
        ConvSpec("TConv", m_i=(8, 8, 3), m_k=(8, 3, 3, 3), m_o=(8, 8, 8),
                 stride=1, padding=1),
        FCSpec("TFC", m_i=(8, 8, 8), k_o=16),
    ))


NETS = {
    "alexnet": alexnet_spec,
    "alexnet-full": alexnet_full_spec,
    "tiny": tiny_net,
}


def build_parser() -> argparse.ArgumentParser:
    """The profile CLI's argument parser: the JAX package's flags, plus
    ``--device``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="alexnet-full", choices=sorted(NETS))
    ap.add_argument("--engines", default=None,
                    help="comma-separated engine names (default: all "
                         "buildable engines)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cache", default=DEFAULT_CACHE_PATH)
    ap.add_argument("--objective", default="latency",
                    help="DSE objective for the plan comparison")
    ap.add_argument("--no-measure", action="store_true",
                    help="cache-only: never run benchmarks (report on "
                         "whatever the cache already holds)")
    ap.add_argument("--invalidate-stale", action="store_true",
                    help="drop cache entries from other torch versions / "
                         "cards before profiling")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    net = NETS[args.net]()
    if args.engines:
        engines = [engines_lib.ENGINES_BY_NAME[n]
                   for n in args.engines.split(",")]
    else:
        engines = [e for e in engines_lib.ALL_ENGINES if e.buildable]
    dtype = _DTYPES[args.dtype]

    cache = ProfileCache.load(args.cache, strict=False, device=args.device)
    if args.invalidate_stale:
        n = cache.invalidate_stale()
        print(f"[profile] invalidated {n} stale cache entr"
              f"{'y' if n == 1 else 'ies'}")
    n_before = len(cache)
    measurements = profile_network(
        net, engines, batch=args.batch, dtype=dtype, warmup=args.warmup,
        repeats=args.repeats, cache=cache,
        measure_on_miss=not args.no_measure, device=args.device)
    path = cache.save(args.cache)
    env = cache.env
    print(f"[profile] {len(measurements)} measurements for {net.name} "
          f"({len(cache) - n_before} new) on {env['device_name']} "
          f"(torch {env['torch_version']}) -> {path}")

    dtype_bytes = torch.tensor([], dtype=dtype).element_size()
    for eng in engines:
        if not any(m.engine == eng.name for m in measurements):
            continue
        rep = calibration_report(eng, list(net), measurements,
                                 batch=args.batch, dtype_bytes=dtype_bytes,
                                 register=True)
        print(f"\n== calibration: engine {eng.name} "
              f"(registered {rep.model.name}) ==")
        print(rep.summary())

    # the paper's before/after: what does measuring change about the plan?
    pricer = MeasuredPricer(cache, measure_on_miss=not args.no_measure,
                            warmup=args.warmup, repeats=args.repeats,
                            dtype=dtype, device=args.device)
    plan_a = scheduler.schedule(net, engines, objective=args.objective,
                                batch=args.batch, dtype_bytes=dtype_bytes)
    plan_m = scheduler.schedule(net, engines, objective=args.objective,
                                batch=args.batch, dtype_bytes=dtype_bytes,
                                price="measured", pricer=pricer)
    print(f"\n== plan ({args.objective}), analytic pricing ==")
    print(plan_a.summary())
    print(f"\n== plan ({args.objective}), measured pricing "
          f"({pricer.hits} cache hits, {pricer.misses} measured) ==")
    print(plan_m.summary())
    changed = [a.spec.name for a, b in zip(plan_a.assignments,
                                           plan_m.assignments)
               if a.engine != b.engine]
    print(f"\n[profile] measurement moved {len(changed)}/{len(net)} layers"
          + (f": {', '.join(changed)}" if changed else ""))


if __name__ == "__main__":
    main()
