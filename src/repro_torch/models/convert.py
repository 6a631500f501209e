"""Carry weights across from numpy arrays (e.g. the JAX package's parameters,
``np.asarray`` on each leaf) into the port.

For a CNN (a ``NetworkSpec``) the two packages share one parameter layout by
design — filters (OC, IC, KH, KW), FC weights (n_in, k_o), FC6's rows in NHWC
flatten order — so conversion is a copy; every shape is still checked against
the network's layer specs.

For a transformer (a ``ModelConfig``) the JAX package stacks its layers for
``lax.scan``: ``decoder.blocks`` holds one tree per position of the layer
pattern with a leading super-block axis, and ``decoder.rem`` the remainder
layers.  Conversion interleaves them into the port's one-dict-per-layer
list — layer i is ``blocks[i % U][i // U]`` for the n_super·U layers of
whole pattern units and ``rem[i - n_super·U]`` after them — and checks
every shape against ``transformer.param_shapes``.  An MoE layer's expert
stacks keep their leading expert axis.  :func:`state_from_numpy` unstacks a
decode cache of the JAX package the same way, and
:func:`opt_state_from_numpy` its AdamW moments (its gradients, a tree of
the parameters' layout, go through :func:`params_from_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from ..core.engines import check_layer_params
from ..core.layer_model import NetworkSpec
from ..optim.adamw import AdamWState
from .transformer import ModelConfig, map_params, param_shapes


def params_from_numpy(net: Union[NetworkSpec, ModelConfig], arrays, *,
                      device="cuda"):
    """One dict of float32 tensors on ``device`` per layer of a CNN, or the
    parameter tree of a transformer (in its ``param_dtype``)."""
    if isinstance(net, ModelConfig):
        return _lm_params(net, arrays, device)
    return _cnn_params(net, arrays, device)


def _cnn_params(net: NetworkSpec, arrays: Sequence[Mapping[str, np.ndarray]],
                device) -> List[Dict[str, torch.Tensor]]:
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


def _unstack(cfg: ModelConfig, blocks, rem) -> List[Any]:
    """The JAX package's (blocks, rem) layer stacks as one tree per layer."""
    u = len(cfg.pattern_unit())
    layers = []
    for i in range(cfg.n_layers):
        s, j = divmod(i, u)
        if s < cfg.n_super:
            layers.append(map_params(lambda _, a, s=s: a[s],
                                     _plain(blocks[j])))
        else:
            layers.append(_plain(rem[i - cfg.n_super * u]))
    return layers


def _lm_params(cfg: ModelConfig, tree: Mapping[str, Any], device,
               dtype=None) -> Dict[str, Any]:
    flat = {k: _plain(v) for k, v in tree.items() if k != "decoder"}
    flat["layers"] = _unstack(cfg, tree["decoder"]["blocks"],
                              tree["decoder"]["rem"])
    shapes = param_shapes(cfg)
    _check_tree(flat, shapes, "params")

    def tensor(_, a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype or cfg.param_dtype)

    return map_params(tensor, flat)


def opt_state_from_numpy(cfg: ModelConfig, state, *,
                         device="cuda") -> AdamWState:
    """The JAX package's ``AdamWState`` (step, and mu and nu in its stacked
    parameter layout; numpy leaves) as the port's: the step as an int32
    scalar, the moments unstacked as :func:`params_from_numpy` unstacks the
    parameters, in fp32."""
    step, mu, nu = state
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        mu=_lm_params(cfg, mu, device, torch.float32),
        nu=_lm_params(cfg, nu, device, torch.float32))


def state_from_numpy(cfg: ModelConfig, cache: Mapping[str, Any], *,
                     device="cuda") -> Dict[str, Any]:
    """A decode cache of the JAX package (``init_cache``, ``init_slot_cache``
    or ``init_slot_cache_paged`` layout, numpy leaves) in the port's layout:
    one entry per layer, each leaf in its own dtype (bfloat16 conv states
    included), ``pos`` and any ``block_tables``.  The cross-attention
    features are not carried: the port has no cross-attention."""
    def tensor(_, a):
        if str(np.asarray(a).dtype) == "bfloat16":
            return torch.from_numpy(np.asarray(a, np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    blocks, rem = cache["layers"]
    out = {"layers": _unstack(cfg, blocks, rem), "pos": cache["pos"]}
    if "block_tables" in cache:
        out["block_tables"] = cache["block_tables"]
    return map_params(tensor, out)


def _plain(tree):
    """A JAX-side subtree with its mappings as dicts (leaves untouched)."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _check_tree(tree, shapes, path: str) -> None:
    if isinstance(shapes, dict):
        if not isinstance(tree, Mapping) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree)
            raise ValueError(f"{path}: keys {got}, expected {sorted(shapes)}")
        for k in shapes:
            _check_tree(tree[k], shapes[k], f"{path}.{k}")
    elif isinstance(shapes, list):
        if len(tree) != len(shapes):
            raise ValueError(f"{path}: {len(tree)} layers, expected "
                             f"{len(shapes)}")
        for i, (t, s) in enumerate(zip(tree, shapes)):
            _check_tree(t, s, f"{path}[{i}]")
    elif tuple(np.shape(tree)) != tuple(shapes):
        raise ValueError(f"{path}: shape {tuple(np.shape(tree))}, expected "
                         f"{tuple(shapes)}")
