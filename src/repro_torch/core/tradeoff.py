"""Trade-off analysis (paper §IV): the quantitative study CNNLab performs.

`analyze` regenerates the paper's Fig. 6 table — per layer, per device:
execution time, throughput, power, energy, GFLOPS/W, GFLOP/J — from the cost
model.  `check_paper_claims` validates the reproduction against the paper's
own reported numbers (DESIGN.md C1–C7).

Energy normalization: the paper reports joules per (unstated) measurement
workload.  Ratios are therefore the validation target; we additionally pick
the single workload constant (109 images) that reproduces the paper's
absolute GPU conv energy, and report absolute joules under it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from .cost_model import CostBreakdown, layer_cost
from .device_models import DE5, K40, K40_CUBLAS, K40_CUDNN, DeviceModel
from .layer_model import NetworkSpec, alexnet_spec

# workload constant reproducing the paper's absolute GPU conv energy (see
# module docstring); claims are checked on ratios, not on this constant.
PAPER_WORKLOAD_IMAGES = 109


@dataclasses.dataclass(frozen=True)
class TradeoffRow:
    layer: str
    kind: str
    device: str
    time_s: float
    throughput_gflops: float
    power_w: float
    energy_j: float
    gflops_per_watt: float
    gflop_per_joule: float

    @staticmethod
    def from_cost(c: CostBreakdown) -> "TradeoffRow":
        return TradeoffRow(
            layer=c.layer, kind=c.kind, device=c.device, time_s=c.t_total,
            throughput_gflops=c.throughput / 1e9, power_w=c.power_w,
            energy_j=c.energy_j, gflops_per_watt=c.gflops_per_watt,
            gflop_per_joule=c.gflop_per_joule)


def analyze(
    net: NetworkSpec,
    devices: Sequence[DeviceModel],
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    direction: str = "fwd",
) -> List[TradeoffRow]:
    rows = []
    for dev in devices:
        for spec in net:
            c = layer_cost(spec, dev, batch=batch, dtype_bytes=dtype_bytes,
                           direction=direction)
            rows.append(TradeoffRow.from_cost(c))
    return rows


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def check_paper_claims(batch: int = PAPER_WORKLOAD_IMAGES) -> Dict[str, dict]:
    """Validate DESIGN.md claims C1–C7 against the paper's reported values.

    Returns {claim: {"value": ..., "expected": ..., "ok": bool, "note": str}}.
    """
    net = alexnet_spec()
    rows_gpu = {r.layer: r for r in analyze(net, [K40], batch=batch)}
    rows_fpga = {r.layer: r for r in analyze(net, [DE5], batch=batch)}
    convs = [l.name for l in net if l.kind == "conv"]
    fcs = [l.name for l in net if l.kind == "fc"]

    out: Dict[str, dict] = {}

    # C1: GPU ~100x faster overall; up to ~1000x on FC layers
    fc_speedups = [rows_fpga[n].time_s / rows_gpu[n].time_s for n in fcs]
    conv_speedups = [rows_fpga[n].time_s / rows_gpu[n].time_s for n in convs]
    out["C1"] = {
        "value": {"fc_speedup_max": max(fc_speedups),
                  "conv_speedup_mean": _mean(conv_speedups)},
        "expected": "conv ~60-100x, FC up to ~1000x",
        "ok": max(fc_speedups) > 300 and 20 < _mean(conv_speedups) < 200,
    }

    # C2: peak throughputs — GPU 1632 GFLOPS (conv), FPGA 25.56 GFLOPS (conv)
    out["C2"] = {
        "value": {"gpu_conv_peak": max(rows_gpu[n].throughput_gflops for n in convs),
                  "fpga_conv_peak": max(rows_fpga[n].throughput_gflops for n in convs)},
        "expected": {"gpu_conv_peak": 1632.0, "fpga_conv_peak": 25.56},
        "ok": abs(max(rows_gpu[n].throughput_gflops for n in convs) - 1632) < 5
        and abs(max(rows_fpga[n].throughput_gflops for n in convs) - 25.56) < 0.5,
    }

    # C3: FPGA ~50x more power-efficient (97 W vs 2.23 W)
    p_ratio = _mean(r.power_w for r in rows_gpu.values()) / _mean(
        r.power_w for r in rows_fpga.values())
    out["C3"] = {"value": {"power_ratio": p_ratio},
                 "expected": "~43x (97/2.23)", "ok": 30 < p_ratio < 60}

    # C4: conv energy similar (paper: 10.24 J FPGA vs 8.67 J GPU, ratio 1.18);
    #     FC energy GPU far better (12.24 J vs 0.64 J, ratio ~19)
    e_conv_gpu = _mean(rows_gpu[n].energy_j for n in convs)
    e_conv_fpga = _mean(rows_fpga[n].energy_j for n in convs)
    e_fc_gpu = _mean(rows_gpu[n].energy_j for n in fcs)
    e_fc_fpga = _mean(rows_fpga[n].energy_j for n in fcs)
    out["C4"] = {
        "value": {"conv_ratio_fpga_over_gpu": e_conv_fpga / e_conv_gpu,
                  "fc_ratio_fpga_over_gpu": e_fc_fpga / e_fc_gpu,
                  "gpu_conv_energy_j": e_conv_gpu,
                  "fpga_conv_energy_j": e_conv_fpga},
        "expected": {"conv_ratio": 10.24 / 8.67, "fc_ratio": 12.24 / 0.64},
        "ok": 0.5 < (e_conv_fpga / e_conv_gpu) < 3.0
        and 8 < (e_fc_fpga / e_fc_gpu) < 40,
    }

    # C5: density — conv: GPU 14.12 vs FPGA 10.58 GFLOPS/W (similar);
    #     FC: GPU 14.20 vs FPGA 0.82 GFLOPS/W
    d_conv_gpu = _mean(rows_gpu[n].gflops_per_watt for n in convs)
    d_conv_fpga = _mean(rows_fpga[n].gflops_per_watt for n in convs)
    d_fc_gpu = _mean(rows_gpu[n].gflops_per_watt for n in fcs)
    d_fc_fpga = _mean(rows_fpga[n].gflops_per_watt for n in fcs)
    out["C5"] = {
        "value": {"conv": (d_conv_gpu, d_conv_fpga), "fc": (d_fc_gpu, d_fc_fpga)},
        "expected": {"conv": (14.12, 10.58), "fc": (14.20, 0.82)},
        "ok": abs(d_fc_gpu - 14.20) < 0.5 and abs(d_fc_fpga - 0.82) < 0.1
        and 0.4 < d_conv_gpu / 14.12 < 1.5 and 0.4 < d_conv_fpga / 10.58 < 1.5,
    }

    # C6: exact FLOP counts, Table II
    fc6 = next(l for l in net if l.name == "FC6")
    fc7 = next(l for l in net if l.name == "FC7")
    fc8 = next(l for l in net if l.name == "FC8")
    vals = {
        "FC6_fwd": fc6.flops(1), "FC7_fwd": fc7.flops(1), "FC8_fwd": fc8.flops(1),
        "FC6_bwd": fc6.bwd_flops(1), "FC7_bwd": fc7.bwd_flops(1),
        "FC8_bwd": fc8.bwd_flops(1),
    }
    expect = {"FC6_fwd": 75497472, "FC7_fwd": 33554432, "FC8_fwd": 8192000,
              "FC6_bwd": 150994944, "FC7_bwd": 67108864, "FC8_bwd": 16384000}
    out["C6"] = {"value": vals, "expected": expect,
                 "ok": all(vals[k] == expect[k] for k in expect)}

    # C7: cuBLAS vs cuDNN — 1.69x fwd speedup, 24.89x bwd; bwd power
    # 78.77 W vs 123.40 W; bwd energy ratio ~44x (31.19/0.70)
    fc_net = NetworkSpec("fc-only", tuple(l for l in net if l.kind == "fc"))
    def total_time(dev, direction):
        return sum(layer_cost(l, dev, batch=batch, direction=direction).t_total
                   for l in fc_net)
    fwd_speedup = total_time(K40_CUDNN, "fwd") / total_time(K40_CUBLAS, "fwd")
    bwd_speedup = total_time(K40_CUDNN, "bwd") / total_time(K40_CUBLAS, "bwd")
    e_cudnn_bwd = sum(layer_cost(l, K40_CUDNN, batch=batch,
                                 direction="bwd").energy_j for l in fc_net)
    e_cublas_bwd = sum(layer_cost(l, K40_CUBLAS, batch=batch,
                                  direction="bwd").energy_j for l in fc_net)
    out["C7"] = {
        "value": {"fwd_speedup": fwd_speedup, "bwd_speedup": bwd_speedup,
                  "bwd_power": (K40_CUDNN.power_bwd["fc"], K40_CUBLAS.power_bwd["fc"]),
                  "bwd_energy_ratio": e_cudnn_bwd / e_cublas_bwd},
        "expected": {"fwd_speedup": 1.69, "bwd_speedup": 24.89,
                     "bwd_power": (123.40, 78.77),
                     "bwd_energy_ratio": 31.19 / 0.70},
        "ok": abs(fwd_speedup - 1.69) < 0.05 and abs(bwd_speedup - 24.89) < 0.5
        and 30 < (e_cudnn_bwd / e_cublas_bwd) < 60,
        "note": ("paper's BP *throughput* claim (cuDNN 1.57x higher) is "
                 "inconsistent with its 24.89x time speedup for identical "
                 "FLOPs (Table II); we validate the time/power/energy claims"),
    }
    return out
