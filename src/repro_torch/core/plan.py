"""ExecutionPlan → runnable forward pass.

The paper's Fig. 4: the API forwards requests via the scheduling middleware;
host code offloads threads to CUDA or OpenCL kernels sharing a virtual
memory space.  Here the compiled plan chains the per-layer callables of
whichever engine the scheduler picked; both buildable engines run on the
same card, so activations pass between them with no copies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .engines import ENGINES_BY_NAME, ExecutionEngine, init_layer_params
from .layer_model import NetworkSpec
from .scheduler import ExecutionPlan, schedule


def init_network_params(net: NetworkSpec, generator: torch.Generator, *,
                        device="cpu") -> List[Dict[str, torch.Tensor]]:
    return [init_layer_params(spec, generator, device=device)
            for spec in net]


def reprice_plan(
    plan: ExecutionPlan,
    *,
    engines: Optional[Sequence[ExecutionEngine]] = None,
    price: str = "measured",
    pricer=None,
    batch: Optional[int] = None,
    dtype_bytes: Optional[int] = None,
) -> ExecutionPlan:
    """Re-run the DSE for a plan's network under a different pricing source
    (the paper's profile-then-offload: the analytic plan is a hypothesis;
    the measured plan is what the runtime actually commits to).

    The operating point (batch / dtype) defaults to the one the plan was
    scheduled at.  Candidate engines default to the plan's own engine set
    *plus every buildable engine* — measurement exists precisely to
    reconsider runnable candidates the analytic model dismissed, so a plan
    that analytically collapsed onto one engine can still move."""
    net = NetworkSpec(plan.network, tuple(a.spec for a in plan.assignments))
    if engines is None:
        names = dict.fromkeys(a.engine for a in plan.assignments)
        names.update((e.name, None) for e in ENGINES_BY_NAME.values()
                     if e.buildable)
        engines = tuple(ENGINES_BY_NAME[n] for n in names)
    return schedule(net, engines, objective=plan.objective,
                    batch=plan.batch if batch is None else batch,
                    dtype_bytes=(plan.dtype_bytes if dtype_bytes is None
                                 else dtype_bytes),
                    price=price, pricer=pricer)


def compile_plan(
    plan: ExecutionPlan,
    *,
    engines: Optional[Sequence[ExecutionEngine]] = None,
    fallback: str = "torch",
    price: Optional[str] = None,
    pricer=None,
    batch: Optional[int] = None,
    dtype_bytes: Optional[int] = None,
):
    """Build `f(x, params) -> y` chaining the per-layer engine callables.

    Cost-only engines (the paper's K40/DE5 models) fall back to `fallback`
    for execution — the plan's *analysis* stays on the modeled device, which
    is how the benchmarks replay the paper's numbers while still producing
    real outputs.

    ``price="measured"`` re-prices the plan through the profiling runtime
    before building (no-op if the plan was already measured-priced), so the
    compiled program follows measurements rather than the analytic
    hypothesis.  The plan actually built — re-priced or not — is attached
    to the returned callable as ``.plan``, and ``.activations(x, params)``
    runs the same chain but returns every layer's output, in order.
    """
    if price is not None and price != plan.pricing:
        plan = reprice_plan(plan, engines=engines, price=price,
                            pricer=pricer, batch=batch,
                            dtype_bytes=dtype_bytes)
    by_name = dict(ENGINES_BY_NAME)
    if engines:
        by_name.update({e.name: e for e in engines})

    fns = []
    for a in plan.assignments:
        eng = by_name[a.engine]
        if not eng.buildable:
            eng = by_name[fallback]
        fns.append(eng.build(a.spec))

    def apply(x: torch.Tensor,
              params: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
        for fn, p in zip(fns, params):
            x = fn(x, p)
        return x

    def activations(x: torch.Tensor, params: Sequence[Dict[str, torch.Tensor]]
                    ) -> List[torch.Tensor]:
        outs = []
        for fn, p in zip(fns, params):
            x = fn(x, p)
            outs.append(x)
        return outs

    apply.plan = plan
    apply.activations = activations
    return apply
