"""The three-term roofline of the dry run's records, on a device model.

Per (arch x shape) on one production mesh (the pod mesh by default):

    compute term    = FLOPs per device      / device.peak_flops
    memory term     = bytes per device      / device.mem_bw
    collective term = collective bytes/dev  / device.link_bw

with the device ``core.device_models.H100`` by default: 989 TFLOP/s bf16,
3.35 TB/s of HBM and 450 GB/s of NVLink each way, the NVIDIA H100 SXM
datasheet's figures at its 700 W limit.  These times are modelled from the
dry run's counts (``launch/dryrun.py``), not measured on a card.  A train
cell's count is the whole step, every microbatch of its gradient
accumulation included: the step runs eagerly.  (The JAX package multiplies
its train cells by ``grad_accum``, since HloCostAnalysis counts the
accumulation loop's body once; the port has no such factor.)

Costs are **calibrated** where the results hold the cell's L0/L1 records
(``dryrun --calibrate``):

    corrected = L0 + (n_layers / unit_len) x (L1 - L0)

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train; 2·N·D for
prefill; 2·N per token for decode.  The useful-compute ratio
MODEL_FLOPS / counted FLOPs exposes recomputation (remat) and dispatch
waste.

Print the table of a results file::

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --results build/dryrun_results.json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from ..configs import registry
from ..core import device_models
from ..models.transformer import count_active_params
from .dryrun import DEFAULT_OUT

_COSTS = ("flops_per_device", "bytes_per_device",
          "collective_bytes_per_device")


def model_flops_per_device(arch_name: str, shape_name: str,
                           n_chips: int) -> float:
    cfg = registry.get(arch_name).config
    n_active = count_active_params(cfg)
    shape = registry.SHAPES[shape_name]
    if shape.mode == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips


def corrected_costs(records: List[Dict]) -> Dict:
    """Combine full-depth records with calibration records."""
    cal = {(r["arch"], r["shape"]): r for r in records
           if r.get("calibration") and r.get("status") == "ok"}
    out = {}
    for r in records:
        if r.get("calibration") or r.get("status") != "ok" \
                or r.get("overrides"):
            continue
        rec = dict(r)
        c = cal.get((r["arch"], r["shape"]))
        if c:
            scale = c["n_layers"] / max(c["unit_len"], 1)
            for k in _COSTS:
                body = c[f"L1_{k}"] - c[f"L0_{k}"]
                rec[f"corrected_{k}"] = c[f"L0_{k}"] + scale * max(body, 0.0)
            # the full run's collectives outside the layers are not in the
            # calibration's body: keep the larger (conservative)
            rec["corrected_collective_bytes_per_device"] = max(
                rec["corrected_collective_bytes_per_device"],
                r["collective_bytes_per_device"])
        else:
            for k in _COSTS:
                rec[f"corrected_{k}"] = r[k]
            rec["uncalibrated"] = True
        out[(r["arch"], r["shape"], r["mesh"])] = rec
    return out


def roofline_rows(records: List[Dict], mesh: str = "pod",
                  device: device_models.DeviceModel = device_models.H100
                  ) -> List[Dict]:
    rows = []
    for (arch, shape, m), r in sorted(corrected_costs(records).items()):
        if m != mesh:
            continue
        t_c = r["corrected_flops_per_device"] / device.peak_flops
        t_m = r["corrected_bytes_per_device"] / device.mem_bw
        t_x = r["corrected_collective_bytes_per_device"] / device.link_bw
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        dom = max(terms, key=terms.get)
        mf = model_flops_per_device(arch, shape, r["n_chips"])
        t_total = max(terms.values())
        rows.append({
            "arch": arch, "shape": shape, "mesh": m,
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "dominant": dom,
            "model_flops_per_device": mf,
            "hlo_flops_per_device": r["corrected_flops_per_device"],
            "useful_ratio": mf / max(r["corrected_flops_per_device"], 1.0),
            # fraction of the compute roofline achieved if the step ran at
            # the modelled time (MODEL_FLOPS / t_total / peak)
            "roofline_fraction": mf / max(t_total, 1e-12) / device.peak_flops,
            "mem_gb_per_device": (r["memory"]["argument_bytes"]
                                  + r["memory"]["temp_bytes"]) / 2**30,
            "uncalibrated": r.get("uncalibrated", False),
        })
    return rows


def detail(row: Dict) -> str:
    """One row as the JAX package's roofline report prints it."""
    return (f"tc={row['t_compute_s'] * 1e3:.1f}ms "
            f"tm={row['t_memory_s'] * 1e3:.1f}ms "
            f"tx={row['t_collective_s'] * 1e3:.1f}ms "
            f"dom={row['dominant']} "
            f"useful={row['useful_ratio']:.2f} "
            f"roofline={row['roofline_fraction']:.2%}"
            + (" UNCAL" if row["uncalibrated"] else ""))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.roofline",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    args = ap.parse_args(argv)
    with open(args.results) as f:
        records = json.load(f)
    device = device_models.H100
    print(f"roofline on {device.name} (modelled: "
          f"{device.peak_flops / 1e12:.0f} TFLOP/s, "
          f"{device.mem_bw / 1e12:.2f} TB/s, "
          f"{device.link_bw / 1e9:.0f} GB/s a link; NVIDIA H100 SXM "
          f"datasheet, 700 W), {args.mesh} mesh")
    for row in roofline_rows(records, args.mesh, device):
        print(f"{row['arch']}:{row['shape']} {detail(row)} "
              f"mem={row['mem_gb_per_device']:.2f}GiB/dev")


if __name__ == "__main__":
    main()
