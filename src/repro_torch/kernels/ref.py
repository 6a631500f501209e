"""Plain PyTorch versions of every kernel in this package.

They are what the kernels are held against (on the CPU in the tests, on the
card in ``chip_smoke.py``), what ``ops`` runs for a CPU tensor, and what the
``torch`` execution engine (core/engines.py) runs on any device.  Layouts
follow the JAX package: activations NHWC, filters (OC, IC, KH, KW) — the
paper's Table I order.  Every function returns a contiguous tensor, so a
kernel that follows a plain layer finds the layout it checks for.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fc_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           activation: str = "none") -> torch.Tensor:
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(x.dtype)


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    if activation == "tanh":
        return torch.tanh(y)
    if activation == "softmax":
        return torch.softmax(y, dim=-1)
    if activation == "none":
        return y
    raise ValueError(f"unknown activation {activation}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *, stride: int = 1,
               padding: int = 0, activation: str = "none") -> torch.Tensor:
    """NHWC input, (OC, IC, KH, KW) filters (paper Table I order)."""
    y = _nhwc(F.conv2d(_nchw(x.float()), w.float(), stride=stride,
                       padding=padding))
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(x.dtype)


def maxpool_ref(x: torch.Tensor, *, window: int = 3,
                stride: int = 2) -> torch.Tensor:
    """VALID max pooling, NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def avgpool_ref(x: torch.Tensor, *, window: int = 3,
                stride: int = 2) -> torch.Tensor:
    """VALID average pooling, NHWC, summed in fp32."""
    return _nhwc(F.avg_pool2d(_nchw(x.float()), window, stride)).to(x.dtype)


def lrn_ref(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """Across-channel local response normalization (AlexNet / Caffe form):

        y = x / (k + (alpha/n) * sum_{window n} x^2) ** beta

    NHWC; the window runs over the channel axis, zero-padded at its edges.
    """
    sq = torch.square(x.float())
    half = local_size // 2
    padded = F.pad(sq, (half, half))
    c = x.shape[-1]
    acc = torch.zeros_like(sq)
    for i in range(local_size):
        acc = acc + padded[..., i:i + c]
    denom = torch.pow(k + (alpha / local_size) * acc, beta)
    return (x.float() / denom).to(x.dtype)
