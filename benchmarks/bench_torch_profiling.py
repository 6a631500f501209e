"""Profiling/calibration benchmark of the PyTorch port ->
BENCH_profiling_torch.json.

    PYTHONPATH=src python -m benchmarks.bench_torch_profiling --scale smoke

What the port's profiling runtime (repro_torch.profiling) buys over the
static analytic cost model on its buildable engines (torch, hopper), in the
JSON keys of the JAX package's benchmarks/bench_profiling.py:

* per layer kind and per engine: analytic vs calibrated prediction error
  (MAPE against the measured medians) and the fitted achieved rates;
* plan deltas: the DSE run with analytic vs measured pricing — which
  layers move engine, and the modeled plan time under each pricing source.

Runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` measures the plain versions on the CPU.  The headline
claim checked at the end: calibration reduces prediction error on every
measured engine.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from repro_torch.core import engines as engines_lib
from repro_torch.core import scheduler
from repro_torch.core.layer_model import alexnet_full_spec
from repro_torch.launch.profile import tiny_net
from repro_torch.profiling import (MeasuredPricer, ProfileCache,
                                   calibration_report, profile_network)


def run_bench(*, net, repeats: int, warmup: int, cache_path: str,
              objective: str = "latency", device="cuda") -> Dict:
    engines = [e for e in engines_lib.ALL_ENGINES if e.buildable]
    cache = ProfileCache.load(cache_path, strict=False, device=device)
    measurements = profile_network(net, engines, repeats=repeats,
                                   warmup=warmup, cache=cache, device=device)
    cache.save(cache_path)

    results = {"config": {
        "net": net.name, "n_layers": len(net), "repeats": repeats,
        "warmup": warmup, **cache.env,
        "engines": [e.name for e in engines],
    }, "engines": {}}

    for eng in engines:
        rep = calibration_report(eng, list(net), measurements)
        results["engines"][eng.name] = {
            "n_measurements": rep.model.n_measurements,
            "analytic_mape": rep.analytic_mape,
            "calibrated_mape": rep.calibrated_mape,
            "per_kind": rep.per_kind(),
            "fitted_rates_gflops": {k: v / 1e9
                                    for k, v in rep.model.throughput.items()},
        }
        print(f"[bench_torch_profiling] {eng.name}: MAPE "
              f"{rep.analytic_mape:.2%} analytic -> "
              f"{rep.calibrated_mape:.2%} calibrated "
              f"({rep.model.n_measurements} measurements)", flush=True)

    pricer = MeasuredPricer(cache, measure_on_miss=True, warmup=warmup,
                            repeats=repeats, autosave=False, device=device)
    plan_a = scheduler.schedule(net, engines, objective=objective)
    plan_m = scheduler.schedule(net, engines, objective=objective,
                                price="measured", pricer=pricer)
    cache.save(cache_path)
    changed = [a.spec.name for a, b in zip(plan_a.assignments,
                                           plan_m.assignments)
               if a.engine != b.engine]
    results["plans"] = {
        "objective": objective,
        "analytic": {
            "assignments": {a.spec.name: a.engine
                            for a in plan_a.assignments},
            "modeled_total_s": plan_a.total_time,
        },
        "measured": {
            "assignments": {a.spec.name: a.engine
                            for a in plan_m.assignments},
            "modeled_total_s": plan_m.total_time,
        },
        "n_changed": len(changed),
        "changed_layers": changed,
    }
    results["calibration_improves_all_engines"] = all(
        e["calibrated_mape"] < e["analytic_mape"]
        for e in results["engines"].values())
    print(f"[bench_torch_profiling] measured pricing moved {len(changed)}/"
          f"{len(net)} layers; measured-plan modeled time "
          f"{plan_m.total_time*1e3:.3f} ms vs analytic-plan belief "
          f"{plan_a.total_time*1e3:.3f} ms", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="smoke", choices=["smoke", "tiny"],
                    help="smoke: full AlexNet (Table I + LRN/pool); "
                         "tiny: 2-layer smoke workload")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--cache", default="build/profile_cache_torch.json")
    ap.add_argument("--out", default="BENCH_profiling_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("bench_torch_profiling: no CUDA device is "
                         "available; pass --device cpu to measure the CPU")

    net = tiny_net() if args.scale == "tiny" else alexnet_full_spec()
    repeats = args.repeats or (3 if args.scale == "tiny" else 5)
    results = run_bench(net=net, repeats=repeats, warmup=2,
                        cache_path=args.cache, device=args.device)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[bench_torch_profiling] wrote {args.out}: calibration improves "
          f"all engines = {results['calibration_improves_all_engines']}")
    if not results["calibration_improves_all_engines"]:
        raise SystemExit("calibrated model did not beat the analytic model")


if __name__ == "__main__":
    main()
