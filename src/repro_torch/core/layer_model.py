"""CNNLab layer abstraction (paper §III.B).

Every network layer is a declarative tuple of parameters, decoupled from any
backend.  The paper defines four tuples:

    Conv  ⟨M_I, M_K, M_O, S, T⟩          (Eq. 5)
    Norm  ⟨M_I, T, S, α, β⟩              (Eq. 6)
    Pool  ⟨M_I, M_O, T, S, N⟩            (Eq. 7)
    FC    ⟨M_I, K_O⟩                     (Eq. 8)

We keep those exactly, and extend the same idea to the transformer-era layer
types our assigned architectures need (attention, MoE, SSM, norm, embedding).
Each spec knows its own FLOP count, parameter bytes and activation bytes, so
the cost model (core/cost_model.py) and the scheduler (core/scheduler.py) can
reason about it analytically — this is what lets the middleware do DSE before
anything is compiled.

FLOP conventions: 1 multiply-accumulate = 2 FLOPs (matches the paper's
Table II exactly: FC6 fwd over 256x6x6 -> 4096 is 2*9216*4096 = 75,497,472).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

Shape3 = Tuple[int, int, int]  # height, width, channels (paper: h x w x dim)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Base class: a declaratively-specified layer (one CNNLab tuple)."""

    name: str

    # ---- accounting interface ---------------------------------------
    def flops(self, batch: int = 1) -> int:
        """Forward FLOPs per batch of `batch` inputs."""
        raise NotImplementedError

    def bwd_flops(self, batch: int = 1) -> int:
        """Backward FLOPs.  Paper's Table II uses exactly 2x forward."""
        return 2 * self.flops(batch)

    def param_count(self) -> int:
        return 0

    def param_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_count() * dtype_bytes

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        """Bytes read + written for the forward pass (I/O traffic)."""
        raise NotImplementedError

    @property
    def kind(self) -> str:
        return type(self).__name__.replace("Spec", "").lower()


# ----------------------------------------------------------------------
# The paper's four tuples (§III.B, Eqs. 5-8)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConvSpec(LayerSpec):
    """Convolutional layer ⟨M_I, M_K, M_O, S, T⟩ (Eq. 5)."""

    m_i: Shape3        # input  (h, w, c_in)
    m_k: Tuple[int, int, int, int]  # kernel (c_out, c_in, kh, kw) — Table I order
    m_o: Shape3        # output (h, w, c_out)
    stride: int = 1
    nonlinearity: str = "relu"   # T ∈ {sigmoid, tanh, relu, none}
    padding: int = 0

    def flops(self, batch: int = 1) -> int:
        oh, ow, oc = self.m_o
        _, ic, kh, kw = self.m_k
        macs = oh * ow * oc * ic * kh * kw
        return batch * 2 * macs

    def param_count(self) -> int:
        oc, ic, kh, kw = self.m_k
        return oc * ic * kh * kw + oc  # + bias

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * (_prod(self.m_i) + _prod(self.m_o)) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class NormSpec(LayerSpec):
    """Normalization layer ⟨M_I, T, S, α, β⟩ (Eq. 6).  T='lrn' is the paper's
    LRN; we also admit 'layernorm'/'rmsnorm' for the transformer archs."""

    m_i: Shape3
    norm_type: str = "lrn"
    local_size: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def flops(self, batch: int = 1) -> int:
        n = _prod(self.m_i)
        if self.norm_type == "lrn":
            # square, windowed sum over `local_size` channels, scale, pow, div
            return batch * n * (2 * self.local_size + 4)
        # layernorm / rmsnorm: mean/var + normalize + affine ≈ 6 ops/elem
        return batch * n * 6

    def param_count(self) -> int:
        if self.norm_type in ("layernorm", "rmsnorm"):
            h, w, c = self.m_i
            return c * (2 if self.norm_type == "layernorm" else 1)
        return 0

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * 2 * _prod(self.m_i) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class PoolSpec(LayerSpec):
    """Pooling layer ⟨M_I, M_O, T, S, N⟩ (Eq. 7)."""

    m_i: Shape3
    m_o: Shape3
    pool_type: str = "max"   # T ∈ {max, avg}
    stride: int = 2
    num_kernels: int = 1     # N
    window: int = 3

    def flops(self, batch: int = 1) -> int:
        # one compare/add per window element per output element
        return batch * _prod(self.m_o) * self.window * self.window

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * (_prod(self.m_i) + _prod(self.m_o)) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class FCSpec(LayerSpec):
    """Fully-connected layer ⟨M_I, K_O⟩ (Eq. 8).

    m_i may be a 3-tuple (flattened internally, like FC6's 256x6x6) or an int.
    """

    m_i: Tuple[int, ...] = (1,)
    k_o: int = 1
    activation: str = "none"   # dropout applied outside; softmax for FC8

    @property
    def n_in(self) -> int:
        return _prod(self.m_i)

    def flops(self, batch: int = 1) -> int:
        return batch * 2 * self.n_in * self.k_o   # == paper Table II exactly

    def param_count(self) -> int:
        return self.n_in * self.k_o + self.k_o

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * (self.n_in + self.k_o) * dtype_bytes


# ----------------------------------------------------------------------
# Transformer-era extensions (same declarative idea, new layer kinds)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EmbeddingSpec(LayerSpec):
    vocab: int = 32000
    d_model: int = 4096
    tied_output: bool = False

    def flops(self, batch: int = 1) -> int:
        return 0  # gather

    def param_count(self) -> int:
        return self.vocab * self.d_model

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * self.d_model * dtype_bytes


@dataclasses.dataclass(frozen=True)
class AttentionSpec(LayerSpec):
    """Self/cross attention with GQA.  seq/kv_len are per-call lengths."""

    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8
    seq: int = 4096
    kv_len: int = 4096
    causal: bool = True
    window: Optional[int] = None      # sliding-window attention if set
    qkv_bias: bool = False
    cross: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def _eff_kv(self) -> int:
        kv = self.kv_len
        if self.window is not None:
            kv = min(kv, self.window)
        return kv

    def flops(self, batch: int = 1) -> int:
        d, h, hk, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        proj = 2 * self.seq * d * (h * hd + 2 * hk * hd) + 2 * self.seq * d * d
        kv = self._eff_kv()
        if self.causal and self.kv_len == self.seq and self.window is None:
            scores = 2 * 2 * h * hd * self.seq * self.seq // 2  # causal half
        else:
            scores = 2 * 2 * h * hd * self.seq * kv
        return batch * (proj + scores)

    def param_count(self) -> int:
        d, h, hk, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        p = d * h * hd + 2 * d * hk * hd + h * hd * d
        if self.qkv_bias:
            p += h * hd + 2 * hk * hd
        return p

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        kv = self._eff_kv()
        io = self.seq * self.d_model * 2 + 2 * kv * self.n_kv_heads * self.head_dim
        return batch * io * dtype_bytes


@dataclasses.dataclass(frozen=True)
class MLPSpec(LayerSpec):
    """Gated (SwiGLU-style, 3 matrices) or plain (2 matrices) FFN."""

    d_model: int = 4096
    d_ff: int = 14336
    seq: int = 4096
    gated: bool = True

    def flops(self, batch: int = 1) -> int:
        mats = 3 if self.gated else 2
        return batch * 2 * self.seq * self.d_model * self.d_ff * mats

    def param_count(self) -> int:
        mats = 3 if self.gated else 2
        return mats * self.d_model * self.d_ff

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * self.seq * (2 * self.d_model + self.d_ff) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class MoESpec(LayerSpec):
    """Mixture-of-experts FFN; active FLOPs = top_k experts per token."""

    d_model: int = 4096
    d_ff: int = 14336
    seq: int = 4096
    n_experts: int = 8
    top_k: int = 2
    gated: bool = True

    def flops(self, batch: int = 1) -> int:
        mats = 3 if self.gated else 2
        expert = 2 * self.seq * self.d_model * self.d_ff * mats * self.top_k
        router = 2 * self.seq * self.d_model * self.n_experts
        return batch * (expert + router)

    def param_count(self) -> int:
        mats = 3 if self.gated else 2
        return self.n_experts * mats * self.d_model * self.d_ff + self.d_model * self.n_experts

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * self.seq * (2 * self.d_model + self.top_k * self.d_ff) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class SSMSpec(LayerSpec):
    """Mamba-1 style selective-SSM block (falcon-mamba) or RG-LRU block."""

    d_model: int = 4096
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    seq: int = 4096
    variant: str = "mamba1"    # or "rglru"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def flops(self, batch: int = 1) -> int:
        di, n, L, d = self.d_inner, self.d_state, self.seq, self.d_model
        if self.variant == "mamba1":
            proj = 2 * L * d * (2 * di) + 2 * L * di * d       # in_proj, out_proj
            conv = 2 * L * di * self.d_conv
            dbc = 2 * L * di * (self.d_state * 2 + math.ceil(d / 16))
            scan = L * di * n * 6                               # recurrence ops
            return batch * (proj + conv + dbc + scan)
        # RG-LRU: gates (2 matmuls di x di) + elementwise recurrence
        proj = 2 * L * d * (2 * di) + 2 * L * di * d
        gates = 2 * 2 * L * di * di
        rec = L * di * 8
        return batch * (proj + gates + rec)

    def param_count(self) -> int:
        di, n, d = self.d_inner, self.d_state, self.d_model
        if self.variant == "mamba1":
            dt_rank = math.ceil(d / 16)
            return (d * 2 * di + di * d + di * self.d_conv
                    + di * (dt_rank + 2 * n) + dt_rank * di + di * n + di)
        return d * 2 * di + di * d + 2 * di * di + 2 * di

    def activation_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        return batch * self.seq * (2 * self.d_model + self.d_inner) * dtype_bytes


# ----------------------------------------------------------------------
# Network = ordered list of layer specs (the paper's "decomposed layers")
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    name: str
    layers: Tuple[LayerSpec, ...]

    def flops(self, batch: int = 1) -> int:
        return sum(l.flops(batch) for l in self.layers)

    def param_count(self) -> int:
        return sum(l.param_count() for l in self.layers)

    def __iter__(self):
        return iter(self.layers)

    def __len__(self):
        return len(self.layers)


def alexnet_spec() -> NetworkSpec:
    """The paper's experimental network, Table I, verbatim."""
    L = (
        # padding=2 reconciles Table I's 224 -> 55 geometry (the classic
        # AlexNet off-by-one; FLOPs use M_O so counts are unaffected)
        ConvSpec("Conv1", m_i=(224, 224, 3), m_k=(96, 3, 11, 11),
                 m_o=(55, 55, 96), stride=4, padding=2, nonlinearity="relu"),
        ConvSpec("Conv2", m_i=(27, 27, 96), m_k=(256, 96, 5, 5),
                 m_o=(27, 27, 256), stride=1, padding=2, nonlinearity="relu"),
        ConvSpec("Conv3", m_i=(13, 13, 256), m_k=(384, 256, 3, 3),
                 m_o=(13, 13, 384), stride=1, padding=1, nonlinearity="relu"),
        ConvSpec("Conv4", m_i=(13, 13, 384), m_k=(384, 384, 3, 3),
                 m_o=(13, 13, 384), stride=1, padding=1, nonlinearity="relu"),
        ConvSpec("Conv5", m_i=(13, 13, 384), m_k=(256, 384, 3, 3),
                 m_o=(13, 13, 256), stride=1, padding=1, nonlinearity="relu"),
        FCSpec("FC6", m_i=(256, 6, 6), k_o=4096, activation="relu"),
        FCSpec("FC7", m_i=(4096,), k_o=4096, activation="relu"),
        FCSpec("FC8", m_i=(4096,), k_o=1000, activation="softmax"),
    )
    return NetworkSpec("alexnet-table1", L)


def alexnet_full_spec() -> NetworkSpec:
    """Table I network with the LRN + pooling layers that sit between the
    convs in the real AlexNet (the paper's FPGA has LRN/Pool modules,
    Table III, so CNNLab schedules them too)."""
    L = (
        ConvSpec("Conv1", m_i=(224, 224, 3), m_k=(96, 3, 11, 11),
                 m_o=(55, 55, 96), stride=4, padding=2),
        NormSpec("LRN1", m_i=(55, 55, 96), norm_type="lrn", local_size=5),
        PoolSpec("Pool1", m_i=(55, 55, 96), m_o=(27, 27, 96), pool_type="max",
                 stride=2, window=3),
        ConvSpec("Conv2", m_i=(27, 27, 96), m_k=(256, 96, 5, 5),
                 m_o=(27, 27, 256), stride=1, padding=2),
        NormSpec("LRN2", m_i=(27, 27, 256), norm_type="lrn", local_size=5),
        PoolSpec("Pool2", m_i=(27, 27, 256), m_o=(13, 13, 256), pool_type="max",
                 stride=2, window=3),
        ConvSpec("Conv3", m_i=(13, 13, 256), m_k=(384, 256, 3, 3),
                 m_o=(13, 13, 384), stride=1, padding=1),
        ConvSpec("Conv4", m_i=(13, 13, 384), m_k=(384, 384, 3, 3),
                 m_o=(13, 13, 384), stride=1, padding=1),
        ConvSpec("Conv5", m_i=(13, 13, 384), m_k=(256, 384, 3, 3),
                 m_o=(13, 13, 256), stride=1, padding=1),
        PoolSpec("Pool5", m_i=(13, 13, 256), m_o=(6, 6, 256), pool_type="max",
                 stride=2, window=3),
        FCSpec("FC6", m_i=(256, 6, 6), k_o=4096, activation="relu"),
        FCSpec("FC7", m_i=(4096,), k_o=4096, activation="relu"),
        FCSpec("FC8", m_i=(4096,), k_o=1000, activation="softmax"),
    )
    return NetworkSpec("alexnet-full", L)
