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
from .scheduler import ExecutionPlan


def init_network_params(net: NetworkSpec, generator: torch.Generator, *,
                        device="cpu") -> List[Dict[str, torch.Tensor]]:
    return [init_layer_params(spec, generator, device=device)
            for spec in net]


def compile_plan(
    plan: ExecutionPlan,
    *,
    engines: Optional[Sequence[ExecutionEngine]] = None,
    fallback: str = "torch",
):
    """Build `f(x, params) -> y` chaining the per-layer engine callables.

    Cost-only engines (the paper's K40/DE5 models) fall back to `fallback`
    for execution — the plan's *analysis* stays on the modeled device, which
    is how the benchmarks replay the paper's numbers while still producing
    real outputs.  The plan is attached to the returned callable as
    ``.plan``, and ``.activations(x, params)`` runs the same chain but
    returns every layer's output, in order.
    """
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
