"""Analytic device models for the CNNLab scheduler.

The PyTorch port's copy: the same models as the JAX package's, plus ``H100``
(the card the port's buildable engines run on), in the port's own registry.

The paper's middleware holds per-accelerator knowledge (it measured the K40
and DE5 boards); ours holds analytic/calibrated models.  Two flavours:

* ``analytic=True`` (TPU v5e): time is the 3-term roofline
  max(compute, memory, collective) from first principles.  This drives the
  real scheduler and the §Roofline analysis.

* ``analytic=False`` (K40, DE5, and the K40 cuDNN/cuBLAS library variants):
  *empirical* models whose per-layer-kind achieved throughput and power are
  calibrated from the paper's own measurements (§IV.B/C, Tables II-III).
  These exist so the trade-off analysis of Fig. 6 / Figs. 7-8 can be
  regenerated and the paper's claims validated (DESIGN.md C1-C7).

Calibration sources (all from the paper):
  K40  : 4.29 TFLOPS fp32 peak, 288 GB/s, avg power 97 W;
         conv eff. set so conv throughput = 1632 GFLOPS (peak claim, Conv4);
         FC throughput = 14.20 GFLOPS/W x 97 W = 1377 GFLOPS (density claim).
  DE5  : Table III module freqs + DSP counts; measured conv peak 25.56 GFLOPS
         (Conv2), FC density 0.82 GFLOPS/W at 2.23 W -> ~1.8 GFLOPS.
  cuDNN/cuBLAS: Fig. 7-8 speedups (1.69x fwd, 24.89x bwd) and powers
         (fwd 79.12/78.73 W, bwd 123.40/78.77 W).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

GiB = 1024 ** 3
MiB = 1024 ** 2


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float                    # FLOP/s (target precision)
    mem_bw: float                        # bytes/s HBM (or DDR/BRAM aggregate)
    link_bw: float = 0.0                 # bytes/s per ICI link
    vmem_bytes: int = 0                  # on-chip scratch (VMEM / BRAM)
    analytic: bool = True
    # kind -> achieved FLOP/s (calibrated; used when analytic=False)
    throughput: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # kind -> watts while running that kind (falls back to `power_active`)
    power: Mapping[str, float] = dataclasses.field(default_factory=dict)
    power_active: float = 100.0
    power_idle: float = 10.0
    # backward-pass throughput overrides (kind -> FLOP/s); default = fwd
    throughput_bwd: Mapping[str, float] = dataclasses.field(default_factory=dict)
    power_bwd: Mapping[str, float] = dataclasses.field(default_factory=dict)
    frequency_hz: float = 0.0

    def achieved_flops(self, kind: str, direction: str = "fwd") -> float:
        if direction == "bwd" and kind in self.throughput_bwd:
            return self.throughput_bwd[kind]
        if kind in self.throughput:
            return self.throughput[kind]
        return self.peak_flops

    def analytic_for(self, kind: str) -> bool:
        """Whether `kind` is priced with the first-principles roofline
        (subclasses with partial empirical coverage override per kind)."""
        return self.analytic

    def roofline_efficiency(self, kind: str) -> float:
        """Model-intrinsic achieved-fraction multiplier for the roofline
        compute term (1.0 here; calibrated models carry the engine's
        nominal efficiency for their unmeasured kinds)."""
        return 1.0

    def watts(self, kind: str, direction: str = "fwd") -> float:
        if direction == "bwd" and kind in self.power_bwd:
            return self.power_bwd[kind]
        return self.power.get(kind, self.power_active)


# ---------------------------------------------------------------------------
# TPU v5e — the target platform (constants given by the assignment brief).
# ---------------------------------------------------------------------------
TPU_V5E = DeviceModel(
    name="tpu-v5e",
    peak_flops=197e12,          # bf16
    mem_bw=819e9,               # HBM
    link_bw=50e9,               # per ICI link
    vmem_bytes=16 * MiB,
    analytic=True,
    power_active=200.0,         # modeled envelope (no meter on target)
    power_idle=60.0,
)

# ---------------------------------------------------------------------------
# Nvidia K40 — the paper's GPU (§IV.A), empirical model.
# ---------------------------------------------------------------------------
_K40_PEAK = 4.29e12
K40 = DeviceModel(
    name="nvidia-k40",
    peak_flops=_K40_PEAK,
    mem_bw=288e9,
    vmem_bytes=12288 * MiB,     # device memory (paper: 12,288 MB)
    analytic=False,
    throughput={
        "conv": 1632e9,          # C2: peak GPU throughput, Conv4
        "fc": 1377e9,            # C5: 14.20 GFLOPS/W x 97 W
        "norm": 300e9,
        "pool": 200e9,
    },
    power={"conv": 97.0, "fc": 97.0, "norm": 97.0, "pool": 97.0},
    power_active=97.0,           # C3: average GPU power
    power_idle=20.0,
)

# cuDNN / cuBLAS library variants of the same board (§IV.C, Figs. 7-8).
# cuBLAS is the fast library; cuDNN fwd = cublas/1.69, bwd = cublas/24.89.
_CUBLAS_FC_FWD = 1377e9
_CUBLAS_FC_BWD = 1377e9
K40_CUBLAS = dataclasses.replace(
    K40,
    name="k40-cublas",
    throughput={**K40.throughput, "fc": _CUBLAS_FC_FWD},
    throughput_bwd={"fc": _CUBLAS_FC_BWD},
    power={"fc": 78.73},
    power_bwd={"fc": 78.77},
)
K40_CUDNN = dataclasses.replace(
    K40,
    name="k40-cudnn",
    throughput={**K40.throughput, "fc": _CUBLAS_FC_FWD / 1.69},
    throughput_bwd={"fc": _CUBLAS_FC_BWD / 24.89},
    power={"fc": 79.12},
    power_bwd={"fc": 123.40},
)

# ---------------------------------------------------------------------------
# Altera DE5 — the paper's FPGA (§IV.A, Table III), empirical per-module model.
# Peak theoretical per module = DSPs x 2 FLOP x module clock.
# ---------------------------------------------------------------------------
_DE5_MODULES = {  # kind: (DSPs, freq MHz) — Table III
    "conv": (162, 171.29),
    "norm": (3, 269.02),
    "fc": (130, 216.16),
    "pool": (0, 304.50),
}
DE5 = DeviceModel(
    name="altera-de5",
    peak_flops=162 * 2 * 171.29e6,     # conv module theoretical: ~55.5 GFLOPS
    mem_bw=25.6e9,                     # 2x DDR3-1600 channels on DE5
    vmem_bytes=52_428_800 // 8,        # 52,428,800 memory *bits* (Table III)
    analytic=False,
    throughput={
        "conv": 25.56e9,               # C2: peak FPGA throughput, Conv2
        "fc": 1.83e9,                  # C5: 0.82 GFLOPS/W x 2.23 W
        "norm": 1.6e9,                 # LRN module: 3 DSPs @ 269 MHz (+LUT math)
        "pool": 2.4e9,                 # comparator tree @ 304.5 MHz (no DSPs)
    },
    power={"conv": 2.23, "fc": 2.23, "norm": 2.23, "pool": 2.23},
    power_active=2.23,                 # C3: FPGA conv-module power
    power_idle=0.5,
    frequency_hz=171.29e6,
)

# ---------------------------------------------------------------------------
# Roofline variants of the paper boards.  The empirical K40/DE5 models only
# know the CNN kinds the paper measured; for layer kinds the paper never ran
# (attention, MLP, MoE, SSM — the serving phases) we price the same silicon
# from first principles instead: peak FLOPs vs memory bandwidth, the 3-term
# roofline the TPU model uses.  These are what phase placement
# (repro.serving.placement) studies the paper's GPU/FPGA split on.
# ---------------------------------------------------------------------------
K40_ROOFLINE = dataclasses.replace(K40, name="nvidia-k40-roofline",
                                   analytic=True)
DE5_ROOFLINE = dataclasses.replace(DE5, name="altera-de5-roofline",
                                   analytic=True)

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM — the port's target card.  Modeled from the datasheet
# (NVIDIA's H100 data sheet, as tabulated in the hopper-kernels guide: 989
# TFLOP/s dense bf16, 80 GB of HBM3 at 3.35 TB/s, 700 W board power); no
# number here was measured.  peak_flops follows the TPU_V5E convention above
# (dense bf16 tensor-core rate); the fp32 CUDA-core rate is 67 TFLOP/s.
# ---------------------------------------------------------------------------
H100 = DeviceModel(
    name="nvidia-h100",
    peak_flops=989e12,          # bf16 dense
    mem_bw=3.35e12,             # HBM3
    link_bw=450e9,              # NVLink, each way
    vmem_bytes=80 * 10**9,      # device memory
    analytic=True,
    power_active=700.0,         # SXM board power limit
    power_idle=70.0,            # modeled: a tenth of the limit, not metered
)

REGISTRY = {m.name: m for m in (TPU_V5E, K40, K40_CUBLAS, K40_CUDNN, DE5,
                                K40_ROOFLINE, DE5_ROOFLINE, H100)}


def get(name: str) -> DeviceModel:
    return REGISTRY[name]


def register(model: DeviceModel, *, overwrite: bool = False) -> DeviceModel:
    """Add a model (e.g. a profiling-calibrated one) to the registry so
    name-keyed consumers — the serving batcher's ``device_name`` — can
    price on it."""
    if model.name in REGISTRY and not overwrite:
        raise ValueError(f"device model {model.name!r} already registered")
    REGISTRY[model.name] = model
    return model


def fpga_module_peak(kind: str) -> float:
    """Theoretical module peak from Table III (DSPs x 2 x clock)."""
    dsps, mhz = _DE5_MODULES[kind]
    return dsps * 2 * mhz * 1e6
