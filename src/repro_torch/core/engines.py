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

``torch`` also builds the serving phases' layer kinds (attention, MLP, MoE,
SSM) as plain PyTorch, so the profiling harness can measure what admission
and phase placement price; ``hopper`` lists ``attention`` among its kinds,
as the JAX package's ``pallas`` engine does, but builds no layer callable
for it (its attention kernels run inside the transformer).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from . import device_models as dm
from .layer_model import (AttentionSpec, ConvSpec, FCSpec, LayerSpec,
                          MLPSpec, MoESpec, NormSpec, PoolSpec, SSMSpec)

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
    if isinstance(spec, AttentionSpec):
        return functools.partial(_attention_apply, spec=spec)
    if isinstance(spec, MLPSpec):
        return functools.partial(_mlp_apply, gated=spec.gated)
    if isinstance(spec, MoESpec):
        return functools.partial(_moe_apply, top_k=spec.top_k,
                                 gated=spec.gated)
    if isinstance(spec, SSMSpec):
        return functools.partial(_ssm_apply, spec=spec)
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
# Decode-step builders (attention / mlp / moe / ssm), plain PyTorch.
#
# These run the serving phases' layer kinds as standalone callables so the
# profiling harness can measure what admission and phase placement price.
# Each mirrors the FLOP structure its spec declares, as the JAX package's
# do: attention scores q against a KV cache of ``kv_len`` entries held in
# params; MoE routes each token to top_k experts; SSM advances the
# recurrence over ``seq`` steps from a zero state.
# ---------------------------------------------------------------------------
def _attention_apply(x, params, *, spec):
    # x: (B, S, D).  Cached K/V live in params and are shared across the
    # batch, so the projection, score and output FLOPs match
    # AttentionSpec.flops
    b, s, _ = x.shape
    h, hk, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = x @ params["wq"]
    k_new = x @ params["wk"]
    v_new = x @ params["wv"]
    if spec.qkv_bias:
        q = q + params["bq"]
        k_new = k_new + params["bk"]
        v_new = v_new + params["bv"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k_new = k_new.reshape(b, s, hk, hd).transpose(1, 2)
    v_new = v_new.reshape(b, s, hk, hd).transpose(1, 2)
    kv = spec._eff_kv()
    if kv > s:
        # prepend the cached prefix so the freshly projected K/V stay live
        # (the decode step both reads the cache and appends to it)
        pre_k = params["k_cache"][None, :, :kv - s].expand(b, hk, kv - s, hd)
        pre_v = params["v_cache"][None, :, :kv - s].expand(b, hk, kv - s, hd)
        k = torch.cat([pre_k, k_new], dim=2)
        v = torch.cat([pre_v, v_new], dim=2)
    else:
        k, v = k_new[:, :, :kv], v_new[:, :, :kv]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    scores = (q @ k.transpose(-1, -2)) / (hd ** 0.5)
    if spec.causal and s > 1:
        mask = torch.tril(torch.ones((s, kv), dtype=torch.bool,
                                     device=x.device), diagonal=kv - s)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    out = torch.softmax(scores, dim=-1) @ v
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ params["wo"]


def _mlp_apply(x, params, *, gated):
    if gated:
        hmid = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        hmid = F.gelu(x @ params["w_up"], approximate="tanh")
    return hmid @ params["w_down"]


def _moe_apply(x, params, *, top_k, gated):
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = flat @ params["w_router"]                    # (T, E)
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    up = params["w_up"][idx]                              # (T, k, d, f)
    down = params["w_down"][idx]                          # (T, k, f, d)
    if gated:
        gate = params["w_gate"][idx]
        hmid = F.silu(torch.einsum("td,tkdf->tkf", flat, gate)) * \
            torch.einsum("td,tkdf->tkf", flat, up)
    else:
        hmid = F.gelu(torch.einsum("td,tkdf->tkf", flat, up),
                      approximate="tanh")
    out = torch.einsum("tkf,tkfd->tkd", hmid, down)
    out = (out * weights[..., None]).sum(dim=1)
    return out.reshape(b, s, d)


def _ssm_apply(x, params, *, spec):
    b, s, _ = x.shape
    di = spec.d_inner
    xz = x @ params["in_proj"]                            # (B, S, 2*di)
    xs, z = xz[..., :di], xz[..., di:]
    ys = []
    if spec.variant == "mamba1":
        n = spec.d_state
        # causal depthwise conv over the sequence
        pad = F.pad(xs, (0, 0, spec.d_conv - 1, 0))
        conv = sum(pad[:, i:i + s] * params["conv_w"][:, i]
                   for i in range(spec.d_conv))
        u = F.silu(conv)
        dbc = u @ params["x_proj"]                        # (B, S, dt+2n)
        dt_rank = params["dt_proj"].shape[0]
        dt = F.softplus(dbc[..., :dt_rank] @ params["dt_proj"])
        bmat, cmat = dbc[..., dt_rank:dt_rank + n], dbc[..., dt_rank + n:]
        a = -torch.exp(params["a_log"])                   # (di, n)
        hstate = torch.zeros((b, di, n), dtype=x.dtype, device=x.device)
        for t in range(s):
            da = torch.exp(dt[:, t, :, None] * a)         # (B, di, n)
            hstate = da * hstate + (dt[:, t] * u[:, t])[..., None] * \
                bmat[:, t, None]
            ys.append(torch.einsum("bdn,bn->bd", hstate, cmat[:, t]))
        y = torch.stack(ys, dim=1) + u * params["d_skip"]
    else:                                                 # rglru
        r = torch.sigmoid(xs @ params["w_r"])
        i = torch.sigmoid(xs @ params["w_i"])
        log_a = -8.0 * F.softplus(params["a_param"]) * r
        hstate = torch.zeros((b, di), dtype=x.dtype, device=x.device)
        for t in range(s):
            a_t = torch.exp(log_a[:, t])
            hstate = a_t * hstate + torch.sqrt(
                torch.clamp(1.0 - a_t * a_t, min=0.0)) * (i[:, t] * xs[:, t])
            ys.append(hstate)
        y = torch.stack(ys, dim=1)
    return (y * F.silu(z)) @ params["out_proj"]


# ---------------------------------------------------------------------------
# Parameters (specs are declarative; engines share one param layout)
# ---------------------------------------------------------------------------
def _param_layout(spec: LayerSpec) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """name -> (shape, init) for every parameter of ``spec``, in the JAX
    package's order.  ``init`` is the fan-in of a He-normal draw, or one of
    "normal" (unit normal), "zeros", "ones", "a_log" (log 1..n per row)."""
    if isinstance(spec, ConvSpec):
        oc, ic, kh, kw = spec.m_k
        return {"w": (tuple(spec.m_k), ic * kh * kw), "b": ((oc,), "zeros")}
    if isinstance(spec, FCSpec):
        return {"w": ((spec.n_in, spec.k_o), spec.n_in),
                "b": ((spec.k_o,), "zeros")}
    if isinstance(spec, AttentionSpec):
        d, h, hk, hd = (spec.d_model, spec.n_heads, spec.n_kv_heads,
                        spec.head_dim)
        p = {"wq": ((d, h * hd), d), "wk": ((d, hk * hd), d),
             "wv": ((d, hk * hd), d), "wo": ((h * hd, d), h * hd),
             "k_cache": ((hk, spec._eff_kv(), hd), "normal"),
             "v_cache": ((hk, spec._eff_kv(), hd), "normal")}
        if spec.qkv_bias:
            p.update(bq=((h * hd,), "zeros"), bk=((hk * hd,), "zeros"),
                     bv=((hk * hd,), "zeros"))
        return p
    if isinstance(spec, MLPSpec):
        d, f = spec.d_model, spec.d_ff
        p = {"w_up": ((d, f), d), "w_down": ((f, d), f)}
        if spec.gated:
            p["w_gate"] = ((d, f), d)
        return p
    if isinstance(spec, MoESpec):
        d, f, e = spec.d_model, spec.d_ff, spec.n_experts
        p = {"w_router": ((d, e), d), "w_up": ((e, d, f), d),
             "w_down": ((e, f, d), f)}
        if spec.gated:
            p["w_gate"] = ((e, d, f), d)
        return p
    if isinstance(spec, SSMSpec):
        d, di, n = spec.d_model, spec.d_inner, spec.d_state
        p = {"in_proj": ((d, 2 * di), d), "out_proj": ((di, d), di)}
        if spec.variant == "mamba1":
            dt_rank = -(-d // 16)        # ceil(d / 16), matches SSMSpec.flops
            p.update({"conv_w": ((di, spec.d_conv), spec.d_conv),
                      "x_proj": ((di, dt_rank + 2 * n), di),
                      "dt_proj": ((dt_rank, di), dt_rank),
                      "a_log": ((di, n), "a_log"),
                      "d_skip": ((di,), "ones")})
        else:
            p.update({"w_r": ((di, di), di), "w_i": ((di, di), di),
                      "a_param": ((di,), "ones")})
        return p
    return {}


def param_shapes(spec: LayerSpec) -> Dict[str, Tuple[int, ...]]:
    """The parameter layout every engine reads: filters (OC, IC, KH, KW),
    FC weights (n_in, k_o), and a bias for each; the LM kinds' projections
    (d_in, d_out), cached K/V and recurrence parameters as the JAX
    package lays them out."""
    return {name: shape for name, (shape, _) in _param_layout(spec).items()}


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
    from ``generator`` on its own device and then moved to ``device``; the
    LM kinds' cached K/V are unit normal and their recurrence constants
    fixed, as in the JAX package."""
    out = {}
    for name, (shape, init) in _param_layout(spec).items():
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "a_log":
            out[name] = torch.log(torch.arange(
                1, shape[1] + 1, dtype=torch.float32,
                device=device)).expand(shape).contiguous()
        else:
            w = torch.randn(shape, generator=generator,
                            device=generator.device)
            if init != "normal":
                w = w * (2.0 / init) ** 0.5
            out[name] = w.to(device)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_CNN_KINDS = ("conv", "fc", "pool", "norm")
_LM_KINDS = ("attention", "mlp", "moe", "ssm", "embedding")

TORCH_ENGINE = ExecutionEngine(
    name="torch", device=dm.H100, kinds=_CNN_KINDS + _LM_KINDS,
    builder=_build_torch, efficiency=0.55)
# "attention" as the JAX package's pallas engine lists it, so phase pricing
# and scheduling see the same kinds; its builder raises for AttentionSpec
HOPPER_ENGINE = ExecutionEngine(
    name="hopper", device=dm.H100, kinds=_CNN_KINDS + ("attention",),
    builder=_build_hopper, efficiency=0.75)

# cost-only paper devices
K40_CUDNN_ENGINE = ExecutionEngine(
    name="k40-cudnn", device=dm.K40_CUDNN, kinds=_CNN_KINDS)
K40_CUBLAS_ENGINE = ExecutionEngine(
    name="k40-cublas", device=dm.K40_CUBLAS, kinds=_CNN_KINDS)
K40_ENGINE = ExecutionEngine(name="k40", device=dm.K40, kinds=_CNN_KINDS)
DE5_ENGINE = ExecutionEngine(name="de5-opencl", device=dm.DE5, kinds=_CNN_KINDS)

# cost-only roofline variants of the paper boards covering the LM kinds —
# the engine set phase placement (repro_torch.serving.placement) prices the
# prefill/decode split on (the paper's GPU/FPGA stage split, applied to the
# two serving phases)
K40_LM_ENGINE = ExecutionEngine(
    name="k40-roofline", device=dm.K40_ROOFLINE, kinds=_CNN_KINDS + _LM_KINDS)
DE5_LM_ENGINE = ExecutionEngine(
    name="de5-roofline", device=dm.DE5_ROOFLINE, kinds=_CNN_KINDS + _LM_KINDS)

# torch first: on a tie (memory-bound layers) the scheduler keeps the first
DEFAULT_ENGINES = (TORCH_ENGINE, HOPPER_ENGINE)
PAPER_ENGINES = (K40_ENGINE, DE5_ENGINE)
# the candidate set for per-phase serving placement; NOT part of ALL_ENGINES
# so the paper-replay DSE benchmarks keep scheduling on the boards as
# measured, not their idealized roofline twins
PLACEMENT_ENGINES = (TORCH_ENGINE, K40_LM_ENGINE, DE5_LM_ENGINE)
ALL_ENGINES = DEFAULT_ENGINES + PAPER_ENGINES + (
    K40_CUDNN_ENGINE, K40_CUBLAS_ENGINE)

ENGINES_BY_NAME = {e.name: e for e in ALL_ENGINES + (K40_LM_ENGINE,
                                                     DE5_LM_ENGINE)}
