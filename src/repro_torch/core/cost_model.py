"""CNNLab cost model: per-layer time / power / energy / performance density.

This is the quantity the paper's middleware optimizes during design-space
exploration (§III.A "trade-off analysis"), generalized to the TPU roofline:

    t_compute    = FLOPs / (chips x achieved FLOP/s)
    t_memory     = bytes  / (chips x HBM bandwidth)
    t_collective = collective bytes / (chips x link bandwidth)
    t_total      = max(t_compute, t_memory, t_collective)   (overlap model)

For empirical device models (K40/DE5, calibrated from the paper's
measurements) only the compute term is used — the measurement already folds
in memory behaviour.

Derived metrics exactly as §IV.B defines them:
    throughput        = FLOPs / t_total              (FLOP/s)
    power             = device watts for the kind    (W)
    energy            = t_total x power              (J)
    perf density (1)  = throughput / power           (FLOPS/W)
    perf density (2)  = FLOPs / energy               (FLOP/J)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .device_models import DeviceModel
from .layer_model import LayerSpec, NetworkSpec


def piecewise_interp(xs: Sequence[float], ys: Sequence[float], x: float) -> float:
    """Piecewise-linear interpolation through measured (x, y) knots.

    The analytic model above prices a step as a sum of per-layer roofline
    terms that scale linearly in FLOPs between any two batch sizes; measured
    latency(batch) curves do not obey that (kernel launch floors, cache
    cliffs, bucket re-jits).  When telemetry supplies real knots, interpolate
    between them instead of assuming linear-FLOP scaling — outside the
    measured range, extrapolate along the nearest segment's slope, clamped
    non-negative.

    ``xs`` must be strictly increasing with at least two knots; shorter
    inputs have no interior to interpolate and callers fall back to the
    analytic model.
    """
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("piecewise_interp needs >= 2 matching knots")
    if x <= xs[0]:
        lo, hi = 0, 1
    elif x >= xs[-1]:
        lo, hi = len(xs) - 2, len(xs) - 1
    else:
        hi = next(i for i, v in enumerate(xs) if v >= x)
        lo = hi - 1
    span = xs[hi] - xs[lo]
    if span <= 0:
        raise ValueError("piecewise_interp knots must be strictly increasing")
    frac = (x - xs[lo]) / span
    return max(ys[lo] + frac * (ys[hi] - ys[lo]), 0.0)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    layer: str
    kind: str
    device: str
    flops: int
    bytes_moved: int
    collective_bytes: int
    t_compute: float
    t_memory: float
    t_collective: float
    power_w: float

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def throughput(self) -> float:
        t = self.t_total
        return self.flops / t if t > 0 else 0.0

    @property
    def energy_j(self) -> float:
        return self.t_total * self.power_w

    @property
    def gflops_per_watt(self) -> float:
        return self.throughput / 1e9 / self.power_w if self.power_w else 0.0

    @property
    def gflop_per_joule(self) -> float:
        e = self.energy_j
        return self.flops / 1e9 / e if e > 0 else 0.0


def layer_cost(
    spec: LayerSpec,
    device: DeviceModel,
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    n_chips: int = 1,
    collective_bytes: int = 0,
    direction: str = "fwd",
    mxu_efficiency: float = 1.0,
) -> CostBreakdown:
    """Cost one layer on one device model.

    ``collective_bytes`` is per-chip traffic attributable to this layer's
    sharding (0 for single-device); the caller (scheduler / roofline reader)
    supplies it either analytically or parsed from compiled HLO.
    """
    flops = spec.flops(batch) if direction == "fwd" else spec.bwd_flops(batch)
    bytes_moved = (
        spec.activation_bytes(batch, dtype_bytes) + spec.param_bytes(dtype_bytes)
    )
    if direction == "bwd":
        bytes_moved *= 2  # re-read activations + write grads (rough model)

    kind = spec.kind
    if device.analytic_for(kind):
        eff_peak = (device.peak_flops * mxu_efficiency
                    * device.roofline_efficiency(kind))
        t_c = flops / (n_chips * eff_peak)
        t_m = bytes_moved / (n_chips * device.mem_bw)
        t_x = (
            collective_bytes / device.link_bw if device.link_bw and collective_bytes else 0.0
        )
        power = device.power_active
    else:
        t_c = flops / (n_chips * device.achieved_flops(kind, direction))
        t_m = 0.0
        t_x = 0.0
        power = device.watts(kind, direction)
    return CostBreakdown(
        layer=spec.name,
        kind=kind,
        device=device.name,
        flops=flops,
        bytes_moved=bytes_moved,
        collective_bytes=collective_bytes,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        power_w=power,
    )


def network_cost(
    net: NetworkSpec,
    device: DeviceModel,
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    n_chips: int = 1,
    direction: str = "fwd",
) -> list:
    return [
        layer_cost(
            l,
            device,
            batch=batch,
            dtype_bytes=dtype_bytes,
            n_chips=n_chips,
            direction=direction,
        )
        for l in net
    ]


# ---------------------------------------------------------------------------
# Offload overhead (the paper's PCIe sync, Fig. 5 step 4)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransferCost:
    """Cost of moving bytes between two engines' devices.

    The paper's runtime pays a host-mediated synchronization whenever
    adjacent stages run on different boards; we price it as the byte
    payload at the slower of the two devices' link bandwidths (falling
    back to memory bandwidth for devices that declare no interconnect).
    Energy charges both devices at idle for the transfer — neither is
    computing while the hand-off drains.
    """

    src: str
    dst: str
    bytes_moved: int
    link_bw: float
    t_transfer: float
    energy_j: float
    # where link_bw came from: "assumed-mem-bw" (datasheet fallback),
    # "provided" (caller passed one, e.g. the profiling runtime's measured
    # inter-device copy rate), or "colocated" (same device, free)
    link_source: str = "assumed-mem-bw"


def transfer_cost(
    n_bytes: int,
    src: DeviceModel,
    dst: DeviceModel,
    *,
    link_bw: Optional[float] = None,
) -> TransferCost:
    """Price an engine-switch hand-off of ``n_bytes`` from ``src`` to ``dst``.

    Same device -> free (XLA's shared 'virtual memory space', plan.py).
    ``link_bw`` overrides the derived bandwidth — pass the measured rate
    from :func:`repro.profiling.transfer.measure_link_bandwidth` where one
    exists; the no-argument fallback (slower endpoint's declared link or
    memory bandwidth) is a datasheet *assumption*, and the result records
    which of the two priced the hand-off in ``link_source``.
    """
    if src.name == dst.name:
        return TransferCost(src=src.name, dst=dst.name, bytes_moved=0,
                            link_bw=float("inf"), t_transfer=0.0,
                            energy_j=0.0, link_source="colocated")
    source = "provided" if link_bw is not None else "assumed-mem-bw"
    if link_bw is None:
        link_bw = min(src.link_bw or src.mem_bw, dst.link_bw or dst.mem_bw)
    t = n_bytes / link_bw if link_bw > 0 else float("inf")
    return TransferCost(
        src=src.name, dst=dst.name, bytes_moved=n_bytes, link_bw=link_bw,
        t_transfer=t, energy_j=t * (src.power_idle + dst.power_idle),
        link_source=source)


# ---------------------------------------------------------------------------
# Objectives (what the user asks the middleware to optimize, §III.A)
# ---------------------------------------------------------------------------
def objective_value(cost: CostBreakdown, objective: str) -> float:
    """Lower is better for every objective."""
    if objective == "latency":
        return cost.t_total
    if objective == "energy":
        return cost.energy_j
    if objective == "edp":  # energy-delay product
        return cost.energy_j * cost.t_total
    if objective == "power":
        return cost.power_w
    if objective == "perf_density":  # maximize GFLOPS/W -> minimize inverse
        d = cost.gflops_per_watt
        return 1.0 / d if d > 0 else float("inf")
    raise ValueError(f"unknown objective: {objective}")


OBJECTIVES = ("latency", "energy", "edp", "power", "perf_density")


# ---------------------------------------------------------------------------
# Speculative decoding (draft/verify on the decode path)
# ---------------------------------------------------------------------------
def expected_tokens_per_round(acceptance: float, k: int) -> float:
    """Expected committed tokens of one speculative round at draft depth k.

    With per-token acceptance rate ``alpha`` (i.i.d. across window
    offsets, the standard speculative-decoding model), the accepted draft
    prefix has expected length sum_{i=1..k} alpha^i and the target always
    commits one more token of its own (the correction after a rejection,
    the bonus after full acceptance):

        E[c] = alpha (1 - alpha^k) / (1 - alpha) + 1        (alpha < 1)
             = k + 1                                        (alpha = 1)
    """
    if k < 1:
        raise ValueError(f"draft depth k must be >= 1, got {k}")
    a = min(max(float(acceptance), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return a * (1.0 - a ** k) / (1.0 - a) + 1.0


def speculative_decode_cost(t_draft_step_s: float, t_verify_s: float,
                            acceptance: float, k: int) -> float:
    """Modeled wall time per *committed* token of speculative decoding.

    One round runs k+1 sequential draft steps (the last writes the draft
    KV for its own final proposal) plus one multi-position verify step on
    the target, and commits :func:`expected_tokens_per_round` tokens:

        t_spec = ((k + 1) t_draft + t_verify) / E[c]

    Compare against the plain per-token time (one target step) to decide
    whether speculation prices better — the paper's offload trade-off
    applied to the decode hot path.
    """
    e = expected_tokens_per_round(acceptance, k)
    return ((k + 1) * t_draft_step_s + t_verify_s) / e
