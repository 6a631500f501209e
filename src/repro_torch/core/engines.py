"""Execution-engine registry — the paper's 'resource pool' (§III.A, Fig. 2).

Each engine couples (a) a device/cost model the scheduler prices layers on,
and (b) an optional builder that turns a LayerSpec into a runnable callable
``f(x, params) -> y`` on tensors.  Two engines are buildable, both on the
H100 model:

* ``torch``  — PyTorch's own operators (kernels/ref.py), the counterpart of
               the JAX package's ``xla`` engine.
* ``hopper`` — the hand-written CUDA kernels (kernels/ops.py), the
               counterpart of its ``pallas`` engine.

The paper's own boards are registered as *cost-only* engines (no builder):
``k40-cudnn``, ``k40-cublas``, ``k40``, ``de5-opencl``.  The scheduler can
plan onto them, but `plan.compile_plan` runs their layers on a buildable
fallback.

This slice builds the CNN layer kinds (the paper's Table III modules); the
LM layer kinds join with the port of the transformer family.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import ops, ref
from . import device_models as dm
from .layer_model import ConvSpec, FCSpec, LayerSpec, NormSpec, PoolSpec

LayerFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ExecutionEngine:
    name: str
    device: dm.DeviceModel
    kinds: Tuple[str, ...]                       # layer kinds it can run
    builder: Optional[Callable[[LayerSpec], LayerFn]] = None
    # scheduler hint: fraction of device peak this engine typically reaches
    # (cuDNN vs cuBLAS showed the library matters — §IV.C)
    efficiency: float = 1.0

    def supports(self, spec: LayerSpec) -> bool:
        return spec.kind in self.kinds

    @property
    def buildable(self) -> bool:
        return self.builder is not None

    def build(self, spec: LayerSpec) -> LayerFn:
        if not self.buildable:
            raise ValueError(
                f"engine {self.name} is cost-only (paper device); cannot build")
        if not self.supports(spec):
            raise ValueError(f"engine {self.name} does not support {spec.kind}")
        return self.builder(spec)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def _build_torch(spec: LayerSpec) -> LayerFn:
    if isinstance(spec, ConvSpec):
        return functools.partial(
            _conv_apply, impl=ref.conv2d_ref, stride=spec.stride,
            padding=spec.padding, activation=spec.nonlinearity)
    if isinstance(spec, FCSpec):
        return functools.partial(_fc_apply, impl=ref.fc_ref,
                                 activation=spec.activation)
    if isinstance(spec, PoolSpec):
        impl = ref.maxpool_ref if spec.pool_type == "max" else ref.avgpool_ref
        return lambda x, params: impl(x, window=spec.window, stride=spec.stride)
    if isinstance(spec, NormSpec) and spec.norm_type == "lrn":
        return lambda x, params: ref.lrn_ref(
            x, local_size=spec.local_size, alpha=spec.alpha, beta=spec.beta)
    raise NotImplementedError(f"torch builder: {type(spec).__name__}")


def _build_hopper(spec: LayerSpec) -> LayerFn:
    if isinstance(spec, ConvSpec):
        return functools.partial(
            _conv_apply, impl=ops.conv2d, stride=spec.stride,
            padding=spec.padding, activation=spec.nonlinearity)
    if isinstance(spec, FCSpec):
        return functools.partial(_fc_apply, impl=ops.fc,
                                 activation=spec.activation)
    if isinstance(spec, PoolSpec):
        return lambda x, params: ops.pool(
            x, window=spec.window, stride=spec.stride, pool_type=spec.pool_type)
    if isinstance(spec, NormSpec) and spec.norm_type == "lrn":
        return lambda x, params: ops.lrn(
            x, local_size=spec.local_size, alpha=spec.alpha, beta=spec.beta)
    raise NotImplementedError(f"hopper builder: {type(spec).__name__}")


def _conv_apply(x, params, *, impl, stride, padding, activation):
    return impl(x, params["w"], params.get("b"), stride=stride,
                padding=padding, activation=activation)


def _fc_apply(x, params, *, impl, activation):
    # flatten NHWC in (H, W, C) order, as the JAX package does, so its FC6
    # weights carry across unchanged
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return impl(x, params["w"], params.get("b"), activation=activation)


# ---------------------------------------------------------------------------
# Parameters (specs are declarative; engines share one param layout)
# ---------------------------------------------------------------------------
def param_shapes(spec: LayerSpec) -> Dict[str, Tuple[int, ...]]:
    """The parameter layout every engine reads: filters (OC, IC, KH, KW),
    FC weights (n_in, k_o), and a bias for each."""
    if isinstance(spec, ConvSpec):
        return {"w": tuple(spec.m_k), "b": (spec.m_k[0],)}
    if isinstance(spec, FCSpec):
        return {"w": (spec.n_in, spec.k_o), "b": (spec.k_o,)}
    return {}


def check_layer_params(spec: LayerSpec,
                       params: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``params`` has exactly the names and shapes of
    :func:`param_shapes` for ``spec``."""
    want = param_shapes(spec)
    got = {name: tuple(t.shape) for name, t in params.items()}
    if got != want:
        raise ValueError(f"{spec.name}: parameters {got}, expected {want}")


def init_layer_params(spec: LayerSpec, generator: torch.Generator, *,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """fp32 He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn
    from ``generator`` on its own device and then moved to ``device``."""
    out = {}
    for name, shape in param_shapes(spec).items():
        if name == "b":
            out[name] = torch.zeros(shape, device=device)
            continue
        fan_in = shape[0] if isinstance(spec, FCSpec) else \
            shape[1] * shape[2] * shape[3]
        w = torch.randn(shape, generator=generator,
                        device=generator.device) * (2.0 / fan_in) ** 0.5
        out[name] = w.to(device)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_CNN_KINDS = ("conv", "fc", "pool", "norm")

TORCH_ENGINE = ExecutionEngine(
    name="torch", device=dm.H100, kinds=_CNN_KINDS,
    builder=_build_torch, efficiency=0.55)
HOPPER_ENGINE = ExecutionEngine(
    name="hopper", device=dm.H100, kinds=_CNN_KINDS,
    builder=_build_hopper, efficiency=0.75)

# cost-only paper devices
K40_CUDNN_ENGINE = ExecutionEngine(
    name="k40-cudnn", device=dm.K40_CUDNN, kinds=_CNN_KINDS)
K40_CUBLAS_ENGINE = ExecutionEngine(
    name="k40-cublas", device=dm.K40_CUBLAS, kinds=_CNN_KINDS)
K40_ENGINE = ExecutionEngine(name="k40", device=dm.K40, kinds=_CNN_KINDS)
DE5_ENGINE = ExecutionEngine(name="de5-opencl", device=dm.DE5, kinds=_CNN_KINDS)

# torch first: on a tie (memory-bound layers) the scheduler keeps the first
DEFAULT_ENGINES = (TORCH_ENGINE, HOPPER_ENGINE)
PAPER_ENGINES = (K40_ENGINE, DE5_ENGINE)
ALL_ENGINES = DEFAULT_ENGINES + PAPER_ENGINES + (
    K40_CUDNN_ENGINE, K40_CUBLAS_ENGINE)

ENGINES_BY_NAME = {e.name: e for e in ALL_ENGINES}
