"""The paper's tables and figures from the PyTorch port, on the H100.

    PYTHONPATH=src python -m benchmarks.bench_torch_paper [--only fig7_8]
        [--device cuda|cpu]

Prints the CSV rows (``bench,name,value,derived,status``) of the JAX
package's ``benchmarks/run.py`` for Table I, Fig. 6, Figs. 7-8, Table III
and the scheduler, from ``repro_torch``'s copies of the core:

* table1, fig6, fig7_8 part 1 (the K40 cuDNN/cuBLAS model replay), Table
  III's DE5 rows and the scheduler rows are analytic, the reference's rows
  exactly (the scheduler plans on the port's engine registry, whose two
  buildable engines sit on the H100 model);
* fig7_8 part 2 is the paper's own library comparison on the card: FC6-8
  at 16 rows through PyTorch (cuBLAS) and through the hand-written matmul
  kernel, forward, and the backward through autograd on PyTorch, timed
  with CUDA events.  It runs only with ``--device cuda`` (the default; no
  card, no run);
* Table III's VMEM rows become each kernel's shared memory per block at
  the shapes the main paths give it, against the 232,448 bytes a block
  may opt into on sm_90, from the kernels' Python mirrors.

Exits nonzero if a row's status is FAIL, MISMATCH or OVERFLOW.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN2
from repro_torch.core import engines, scheduler, tradeoff
from repro_torch.core.cost_model import OBJECTIVES, layer_cost
from repro_torch.core.device_models import (DE5, K40, K40_CUBLAS, K40_CUDNN,
                                            _DE5_MODULES, fpga_module_peak)
from repro_torch.core.layer_model import (FCSpec, alexnet_full_spec,
                                          alexnet_spec)
from repro_torch.kernels import (conv2d, flash_attention, lrn, matmul, ops,
                                 paged_attention, pooling, ref)

_EXPECTED = {  # Table II, fp operations per image
    ("FC6", "fwd"): 75_497_472, ("FC7", "fwd"): 33_554_432,
    ("FC8", "fwd"): 8_192_000,
    ("FC6", "bwd"): 150_994_944, ("FC7", "bwd"): 67_108_864,
    ("FC8", "bwd"): 16_384_000,
}
_FC = [layer for layer in alexnet_spec() if isinstance(layer, FCSpec)]
FC_ROWS = 16                   # the reference's measured FC batch
FP32_TOL = 2e-4                # tests/test_kernels.py
SMEM_LIMIT = paged_attention.SMEM_LIMIT
SERVE_PAGE = 16                # the serving runtime's page (block) size
BATCH = 64                     # the AlexNet plans' batch


def table1_rows():
    """Paper Table I/II: layer descriptions and exact FLOP counts."""
    rows = []
    for spec in alexnet_spec():
        fwd, bwd = spec.flops(1), spec.bwd_flops(1)
        for d, v in (("fwd", fwd), ("bwd", bwd)):
            exp = _EXPECTED.get((spec.name, d))
            ok = "" if exp is None else ("MATCH" if v == exp else
                                         f"MISMATCH(exp={exp})")
            rows.append(("table1_flops", f"{spec.name}_{d}", v,
                         f"params={spec.param_count()}", ok))
    return rows


def fig6_rows():
    """Paper Fig. 6: the K40 against the DE5, per layer, and claims C1-C5."""
    rows = []
    for r in tradeoff.analyze(alexnet_spec(), [K40, DE5],
                              batch=tradeoff.PAPER_WORKLOAD_IMAGES):
        rows.append(("fig6_tradeoff", f"{r.device}:{r.layer}",
                     r.time_s * 1e6,
                     f"thr={r.throughput_gflops:.2f}GFLOPS "
                     f"P={r.power_w:.2f}W E={r.energy_j:.3f}J "
                     f"dens={r.gflops_per_watt:.2f}GFLOPS/W "
                     f"ope={r.gflop_per_joule:.2f}GFLOP/J", ""))
    for name, c in tradeoff.check_paper_claims().items():
        rows.append(("fig6_claims", name, 1.0 if c["ok"] else 0.0,
                     str(c["value"])[:120], "PASS" if c["ok"] else "FAIL"))
    return rows


def fig7_fig8_model_rows():
    """Paper Figs. 7-8, part 1: the K40 cuDNN/cuBLAS models replay the
    paper's speedup and energy deltas (claim C7)."""
    rows = []
    for direction in ("fwd", "bwd"):
        dnn, blas = ([layer_cost(layer, dev, batch=109, direction=direction)
                      for layer in _FC] for dev in (K40_CUDNN, K40_CUBLAS))
        t_dnn, t_blas = (sum(c.t_total for c in cs) for cs in (dnn, blas))
        e_dnn, e_blas = (sum(c.energy_j for c in cs) for cs in (dnn, blas))
        expected = 1.69 if direction == "fwd" else 24.89
        rows.append(("fig7_8_model", f"cublas_speedup_{direction}",
                     t_dnn / t_blas, f"paper={expected}",
                     "MATCH" if abs(t_dnn / t_blas - expected) < 0.1 * expected
                     else "MISMATCH"))
        rows.append(("fig7_8_model", f"energy_ratio_{direction}",
                     e_dnn / e_blas, "cuDNN/cuBLAS energy", ""))
    return rows


def _time_us(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median microseconds of one call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks) * 1e3


def fig7_fig8_measured_rows():
    """Paper Figs. 7-8, part 2, on the card: PyTorch's matmul (cuBLAS)
    against the matmul kernel for FC6-8 at FC_ROWS rows, forward, each
    kernel output held to PyTorch's; the backward through autograd on
    PyTorch."""
    if not torch.cuda.is_available():
        raise RuntimeError("fig7_8 part 2 needs a CUDA device; pass "
                           "--device cpu for the analytic rows alone")
    rng = np.random.default_rng(0)
    rows = []
    for layer in _FC:
        x = torch.from_numpy(rng.normal(size=(FC_ROWS, layer.n_in))
                             .astype(np.float32)).cuda()
        w = torch.from_numpy(rng.normal(size=(layer.n_in, layer.k_o))
                             .astype(np.float32)).cuda()
        want, got = ref.matmul_ref(x, w), ops.matmul(x, w)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
        rows.append(("fig7_8_measured", f"{layer.name}_fwd_torch_us",
                     _time_us(lambda: ref.matmul_ref(x, w)),
                     "torch.matmul (cuBLAS)", ""))
        rows.append(("fig7_8_measured", f"{layer.name}_fwd_hopper_us",
                     _time_us(lambda: ops.matmul(x, w)),
                     f"matmul kernel; max_abs_err={err:.3e}",
                     "MATCH" if ok else "MISMATCH"))
        xg, wg = x.requires_grad_(), w.requires_grad_()
        rows.append(("fig7_8_measured", f"{layer.name}_bwd_torch_us",
                     _time_us(lambda: torch.autograd.grad(
                         ref.matmul_ref(xg, wg).sum(), (xg, wg))),
                     "forward + backward, autograd (cuBLAS)", ""))
    return rows


def _smem_row(name: str, n_bytes: int, what: str):
    return ("table3_smem", name, n_bytes,
            f"B of {SMEM_LIMIT} per block ({100 * n_bytes / SMEM_LIMIT:.1f}"
            f"%); {what}", "FITS" if n_bytes <= SMEM_LIMIT else "OVERFLOW")


def smem_rows():
    """Each kernel's shared memory per block at the main paths' shapes:
    AlexNet's layers at batch 64 in fp32, flash at every head dim it takes,
    paged attention at qwen2-1.5B's serve shape in bf16."""
    rows = []
    for spec in alexnet_full_spec():
        if spec.kind == "conv":
            oh, ow, oc = spec.m_o
            bn = conv2d.tile_n(BATCH * oh * ow, oc)
            rows.append(_smem_row(f"conv2d_{spec.name}",
                                  conv2d.smem_bytes(bn), f"N tile {bn}"))
        elif spec.kind == "pool":
            h, w, c = spec.m_i
            oh = (h - spec.window) // spec.stride + 1
            ow = (w - spec.window) // spec.stride + 1
            band, owt, smem = pooling.plan(w, c, oh, ow, spec.window,
                                           spec.stride, 4)
            rows.append(_smem_row(f"pool_{spec.name}", smem,
                                  f"tile of {band} x {owt} outputs"))
        elif spec.kind == "norm":
            c = spec.m_i[-1]
            rows.append(_smem_row(f"lrn_{spec.name}",
                                  lrn.smem_bytes(c, spec.local_size, 4),
                                  f"C {c}, n {spec.local_size}"))
    for elem, dtype in ((4, "fp32"), (2, "bf16")):
        rows.append(_smem_row(f"matmul_{dtype}", matmul.smem_bytes(elem),
                              f"{matmul.STAGES} stages"))
        for d in flash_attention.HEAD_DIMS:
            rows.append(_smem_row(f"flash_attention_d{d}_{dtype}",
                                  flash_attention.smem_bytes(d, elem),
                                  f"head dim {d}"))
    group = QWEN2.n_heads // QWEN2.n_kv_heads
    rows.append(_smem_row(
        "paged_attention_qwen2",
        paged_attention.smem_bytes(group, SERVE_PAGE, QWEN2.hd, 2),
        f"group {group}, pages of {SERVE_PAGE}, head dim {QWEN2.hd}, bf16"))
    return rows


def table3_rows():
    """Paper Table III: the DE5's module inventory, then every kernel's
    shared memory per block (the port's 'does the module fit the fabric')."""
    rows = [("table3_fpga", f"de5_{kind}", fpga_module_peak(kind) / 1e9,
             f"DSPs={dsps} clock={mhz}MHz (theoretical GFLOPS)", "")
            for kind, (dsps, mhz) in _DE5_MODULES.items()]
    return rows + smem_rows()


def scheduler_rows():
    """The CNNLab DSE: scheduling latency for AlexNet over the full engine
    registry, plan quality across objectives, and a power-capped plan."""
    rows = []
    net = alexnet_full_spec()
    t0 = time.perf_counter()
    reps = 50
    for _ in range(reps):
        scheduler.schedule(net, engines.ALL_ENGINES, objective="latency")
    dse_us = (time.perf_counter() - t0) / reps * 1e6
    rows.append(("scheduler", "dse_latency_us", dse_us,
                 f"{len(net)} layers x {len(engines.ALL_ENGINES)} engines", ""))
    for obj in OBJECTIVES:
        plan = scheduler.schedule(net, engines.ALL_ENGINES, objective=obj,
                                  batch=109)
        picks = ",".join(sorted({a.engine for a in plan.assignments}))
        rows.append(("scheduler", f"plan_{obj}", plan.total_time * 1e3,
                     f"ms total; E={plan.total_energy:.2f}J "
                     f"peakP={plan.peak_power:.1f}W engines={picks}", ""))
    plan = scheduler.schedule(net, engines.ALL_ENGINES, objective="latency",
                              power_cap_w=50.0, batch=109)
    rows.append(("scheduler", "plan_latency_cap50W", plan.total_time * 1e3,
                 f"ms total; peakP={plan.peak_power:.1f}W", ""))
    return rows


def fig7_fig8_rows(device="cuda"):
    """Figs. 7-8: the model replay, and on a CUDA device the measurement."""
    rows = fig7_fig8_model_rows()
    if torch.device(device).type == "cuda":
        rows += fig7_fig8_measured_rows()
    return rows


MODULES = {
    "table1": lambda device: table1_rows(),
    "fig6": lambda device: fig6_rows(),
    "fig7_8": fig7_fig8_rows,
    "table3": lambda device: table3_rows(),
    "scheduler": lambda device: scheduler_rows(),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, choices=list(MODULES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) runs fig7_8 part 2 on the card; "
                         "cpu prints the analytic and shared-memory rows")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("bench_torch_paper: no CUDA device is available; "
                         "pass --device cpu for the analytic rows alone")

    mods = {args.only: MODULES[args.only]} if args.only else MODULES
    print("bench,name,value,derived,status")
    failures = []
    for key, fn in mods.items():
        try:
            for bench, name, value, derived, status in fn(args.device):
                print(f"{bench},{name},{value},{derived!r},{status}")
                if status in ("FAIL", "MISMATCH", "OVERFLOW"):
                    failures.append((bench, name, status))
        except Exception as e:            # report every module, then fail
            traceback.print_exc()
            failures.append((key, "exception", str(e)))
    if failures:
        print(f"\n{len(failures)} benchmark failures:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        raise SystemExit(1)
    print("\nall benchmarks passed")


if __name__ == "__main__":
    main()
