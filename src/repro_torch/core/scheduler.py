"""CNNLab runtime scheduler: design-space exploration with trade-off analysis.

The paper (§III.A): "the structure of the NN input model will undergo the
design space exploration and trade-off analysis in the middleware support
... this process yields a succession of hardware mappings of the NN model
onto the particular FPGA-based or GPU-based platforms".

Here: for every layer tuple, enumerate candidate (engine) mappings, price
each with the cost model, and pick per the user's objective.  Because layer
costs are independent given the engine set (layers execute in sequence,
§II), per-layer argmin IS the global optimum for separable objectives —
`schedule_exhaustive` checks this by brute force.  For the non-separable
power-capped objective we schedule cheapest-under-cap.

A plan also carries per-layer *offload overhead* (the paper's PCIe sync,
Fig. 5 step 4): switching engines between adjacent layers costs the
activation transfer at link bandwidth.

Pricing: ``price="analytic"`` uses the static device models.  Measured
(profile-then-offload) pricing arrives with the port of the profiling
runtime (ROADMAP item 7); until then ``price="measured"`` raises.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

from .cost_model import CostBreakdown, layer_cost, objective_value, \
    transfer_cost
from .engines import ENGINES_BY_NAME, ExecutionEngine
from .layer_model import LayerSpec, NetworkSpec


@dataclasses.dataclass(frozen=True)
class Assignment:
    spec: LayerSpec
    engine: str
    cost: CostBreakdown


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    network: str
    objective: str
    assignments: Tuple[Assignment, ...]
    pricing: str = "analytic"
    # the operating point the plan was priced at
    batch: int = 1
    dtype_bytes: int = 4

    @property
    def total_time(self) -> float:
        return sum(a.cost.t_total for a in self.assignments)

    @property
    def total_energy(self) -> float:
        return sum(a.cost.energy_j for a in self.assignments)

    @property
    def peak_power(self) -> float:
        return max((a.cost.power_w for a in self.assignments), default=0.0)

    def total_objective(self) -> float:
        return sum(objective_value(a.cost, self.objective)
                   for a in self.assignments)

    def engine_of(self, layer_name: str) -> str:
        for a in self.assignments:
            if a.spec.name == layer_name:
                return a.engine
        raise KeyError(layer_name)

    def offload_overhead(self, engines_by_name=None):
        """Per-boundary engine-switch costs (the paper's PCIe sync, Fig. 5
        step 4): wherever adjacent layers run on different engines, the
        producer's output activation crosses at link bandwidth.  Returns
        ``[(layer_a, layer_b, TransferCost), ...]`` for the switching
        boundaries; total extra seconds = sum of ``t_transfer``."""
        by_name = engines_by_name or ENGINES_BY_NAME
        out = []
        for a, b in zip(self.assignments, self.assignments[1:]):
            if a.engine == b.engine:
                continue
            n_bytes = a.spec.activation_bytes(
                self.batch, self.dtype_bytes) // 2   # producer's output half
            out.append((a.spec.name, b.spec.name, transfer_cost(
                n_bytes, by_name[a.engine].device, by_name[b.engine].device)))
        return out

    def summary(self) -> str:
        rows = [f"{'layer':<8} {'kind':<6} {'engine':<12} "
                f"{'time(ms)':>10} {'GFLOPS':>9} {'W':>7} {'mJ':>9}"]
        for a in self.assignments:
            c = a.cost
            rows.append(
                f"{a.spec.name:<8} {c.kind:<6} {a.engine:<12} "
                f"{c.t_total*1e3:>10.4f} {c.throughput/1e9:>9.1f} "
                f"{c.power_w:>7.2f} {c.energy_j*1e3:>9.4f}")
        rows.append(f"total: {self.total_time*1e3:.3f} ms, "
                    f"{self.total_energy:.4f} J, peak {self.peak_power:.1f} W")
        return "\n".join(rows)


def _candidate_costs(
    spec: LayerSpec,
    engines: Sequence[ExecutionEngine],
    *,
    batch: int,
    dtype_bytes: int,
    n_chips: int,
    direction: str,
) -> Dict[str, CostBreakdown]:
    out = {}
    for eng in engines:
        if not eng.supports(spec):
            continue
        eff = eng.efficiency if eng.device.analytic else 1.0
        out[eng.name] = layer_cost(
            spec, eng.device, batch=batch, dtype_bytes=dtype_bytes,
            n_chips=n_chips, direction=direction, mxu_efficiency=eff)
    if not out:
        raise ValueError(f"no engine supports layer {spec.name} ({spec.kind})")
    return out


def schedule(
    net: NetworkSpec,
    engines: Sequence[ExecutionEngine],
    *,
    objective: str = "latency",
    batch: int = 1,
    dtype_bytes: int = 4,
    n_chips: int = 1,
    direction: str = "fwd",
    power_cap_w: Optional[float] = None,
    price: str = "analytic",
) -> ExecutionPlan:
    """Per-layer DSE.  `power_cap_w` adds the paper's motivating constraint
    ("data centers quite power consuming"): only engines whose running power
    fits the cap are eligible; if none fit, the lowest-power engine wins."""
    if price == "measured":
        raise NotImplementedError(
            "measured pricing arrives with the port of the profiling runtime "
            "(ROADMAP item 7); schedule with price='analytic'")
    if price != "analytic":
        raise ValueError(f"unknown pricing source: {price!r}")
    assignments = []
    for spec in net:
        cands = _candidate_costs(spec, engines, batch=batch,
                                 dtype_bytes=dtype_bytes, n_chips=n_chips,
                                 direction=direction)
        pool = cands
        if power_cap_w is not None:
            capped = {n: c for n, c in cands.items() if c.power_w <= power_cap_w}
            pool = capped or {min(cands, key=lambda n: cands[n].power_w):
                              cands[min(cands, key=lambda n: cands[n].power_w)]}
        best = min(pool, key=lambda n: objective_value(pool[n], objective))
        assignments.append(Assignment(spec, best, pool[best]))
    return ExecutionPlan(net.name, objective, tuple(assignments),
                         pricing=price, batch=batch, dtype_bytes=dtype_bytes)


def schedule_exhaustive(
    net: NetworkSpec,
    engines: Sequence[ExecutionEngine],
    *,
    objective: str = "latency",
    batch: int = 1,
    dtype_bytes: int = 4,
    n_chips: int = 1,
    direction: str = "fwd",
) -> ExecutionPlan:
    """Brute-force over the full engine-assignment product.  Exponential —
    test/validation use only (proves the greedy scheduler optimal for
    separable objectives)."""
    per_layer = [
        _candidate_costs(s, engines, batch=batch, dtype_bytes=dtype_bytes,
                         n_chips=n_chips, direction=direction)
        for s in net
    ]
    best_plan, best_val = None, float("inf")
    for combo in itertools.product(*[sorted(c) for c in per_layer]):
        val = sum(objective_value(per_layer[i][name], objective)
                  for i, name in enumerate(combo))
        if val < best_val:
            best_val = val
            best_plan = combo
    assignments = tuple(
        Assignment(spec, name, per_layer[i][name])
        for i, (spec, name) in enumerate(zip(net, best_plan)))
    return ExecutionPlan(net.name, objective, assignments)
