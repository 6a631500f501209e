"""Carry weights across from numpy arrays (e.g. the JAX package's parameters,
``np.asarray`` on each leaf) into the port.

The two packages share one parameter layout by design — filters
(OC, IC, KH, KW), FC weights (n_in, k_o), FC6's rows in NHWC flatten order —
so conversion is a copy; every shape is still checked against the network's
layer specs.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..core.engines import check_layer_params
from ..core.layer_model import NetworkSpec


def params_from_numpy(net: NetworkSpec,
                      arrays: Sequence[Mapping[str, np.ndarray]], *,
                      device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One dict of float32 tensors on ``device`` per layer of ``net``."""
    if len(arrays) != len(net):
        raise ValueError(f"{len(arrays)} parameter dicts for the "
                         f"{len(net)} layers of {net.name}")
    out = []
    for spec, layer in zip(net, arrays):
        tensors = {name: torch.from_numpy(np.array(a, dtype=np.float32))
                   .to(device) for name, a in layer.items()}
        check_layer_params(spec, tensors)
        out.append(tensors)
    return out
