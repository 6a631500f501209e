"""AlexNet (paper Table I) as a CNNLab application.

The network is declared as layer tuples (core.layer_model.alexnet_full_spec),
scheduled by the CNNLab middleware onto execution engines, and compiled into
one forward pass.  This is the paper's own experimental model.

Inference only: the parameters are buffers, and the Hopper kernels have no
backward pass yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..core import engines as eng
from ..core import plan as plan_lib
from ..core import scheduler as sched
from ..core.layer_model import LayerSpec, NetworkSpec, alexnet_full_spec


class _LayerParams(nn.Module):
    """One layer's parameters, as buffers named as the engines read them."""

    def __init__(self, spec: LayerSpec, params: Dict[str, torch.Tensor],
                 device: torch.device):
        super().__init__()
        eng.check_layer_params(spec, params)
        for name, t in params.items():
            self.register_buffer(name, t.to(device))

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers(recurse=False))


class AlexNet(nn.Module):
    """Schedulable AlexNet.  objective/engines pick the execution mapping.

    ``device`` defaults to the card and raises where there is none; pass
    ``device="cpu"`` to run the plain versions on the CPU.  ``params`` (one
    dict per layer, e.g. from ``models.convert.params_from_numpy``) defaults
    to a He-normal init drawn from a generator seeded with ``seed``.
    """

    def __init__(self, *, objective: str = "latency",
                 engines: Sequence[eng.ExecutionEngine] = eng.DEFAULT_ENGINES,
                 net: Optional[NetworkSpec] = None, device="cuda",
                 params: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                 seed: int = 0):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AlexNet: no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        self.net = net or alexnet_full_spec()
        self.plan = sched.schedule(self.net, engines, objective=objective)
        self._apply = plan_lib.compile_plan(self.plan)
        if params is None:
            params = plan_lib.init_network_params(
                self.net, torch.Generator().manual_seed(seed))
        if len(params) != len(self.net):
            raise ValueError(f"{len(params)} parameter dicts for the "
                             f"{len(self.net)} layers of {self.net.name}")
        self.layers = nn.ModuleList(
            _LayerParams(spec, p, device) for spec, p in zip(self.net, params))

    def params(self) -> List[Dict[str, torch.Tensor]]:
        return [layer.as_dict() for layer in self.layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images on the model's device -> (B, classes)
        probabilities."""
        return self._apply(x, self.params())

    def activations(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every layer's output for ``x``, in order; the last is forward's."""
        return self._apply.activations(x, self.params())
