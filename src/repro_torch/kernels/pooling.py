"""Pooling kernel for Hopper — the Pool module (paper Table III, 'Pooling').

Wraps ``csrc/pooling.cu``, which replaces the JAX package's ``pool_pallas``:
VALID max or average pooling over window x window taps at a stride, NHWC,
the average taken in fp32.  The plain versions are ``ref.maxpool_ref`` and
``ref.avgpool_ref``.
"""
from __future__ import annotations

import torch

from . import _build

SOURCE = "pooling.cu"
POOL_TYPES = ("max", "avg")
_ARGTYPES = (_build.PTR,) * 2 + (_build.INT,) * 10 + (_build.PTR,)


def pool_cuda(x: torch.Tensor, *, window: int = 3, stride: int = 2,
              pool_type: str = "max") -> torch.Tensor:
    """x (N, H, W, C): a contiguous CUDA tensor, float32 or bfloat16."""
    device = _build.check_cuda("pool", x)
    if x.dim() != 4:
        raise ValueError(f"pool: input {tuple(x.shape)} is not NHWC")
    if pool_type not in POOL_TYPES:
        raise ValueError(f"pool: pool_type {pool_type!r} not in {POOL_TYPES}")
    if window < 1 or stride < 1:
        raise ValueError(f"pool: window {window}, stride {stride}")
    n, h, w, c = x.shape
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    if min(n, c, oh, ow) <= 0:
        raise ValueError(f"pool: empty output for input {tuple(x.shape)}, "
                         f"window {window}")
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=device)
    with _build.device_scope(device):
        _build.launch("repro_pool", _ARGTYPES, x.data_ptr(), out.data_ptr(),
                      n, h, w, c, oh, ow, window, stride,
                      int(pool_type == "max"), _build.DTYPES[x.dtype],
                      _build.stream(device))
    pool_cuda.launches += 1
    return out


pool_cuda.launches = 0
