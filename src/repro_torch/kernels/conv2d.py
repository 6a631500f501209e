"""Implicit-GEMM convolution kernel for Hopper, 3xTF32 on the tensor
cores — the Conv module (paper Table III, 'Conv Layer').

Wraps ``csrc/conv2d.cu``, which replaces the JAX package's
``conv2d_pallas``: NHWC convolution with stride and zero padding, (OC, IC,
KH, KW) filters, fused bias and activation.  The kernel gathers patches
straight from the NHWC input, treating padding taps as zeros, so neither a
padded input nor an im2col matrix is made.  Its pre-pass splits the filters
into TF32 high and low parts in a workspace this wrapper allocates; the
products hi*hi + hi*lo + lo*hi keep fp32 accuracy.  The plain version is
``ref.conv2d_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .matmul import ACTIVATIONS

SOURCE = "conv2d.cu"
_ARGTYPES = (_build.PTR,) * 5 + (_build.INT,) * 13 + (_build.PTR,)

# the kernel's tile rows and k slice (csrc/conv2d.cu kBM, kBK)
TILE_M, TILE_K = 64, 32


def padded_k(ic: int, kh: int, kw: int) -> int:
    """K = KH * KW * IC rounded up to TILE_K: the split filters' row."""
    return -(-kh * kw * ic // TILE_K) * TILE_K


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                padding: int = 0, activation: str = "none") -> torch.Tensor:
    """x (N, H, W, IC), w (OC, IC, KH, KW), bias (OC,): contiguous CUDA
    tensors of one dtype (float32 or bfloat16).  Returns (N, OH, OW, OC)."""
    device = _build.check_cuda("conv2d", x, w, bias)
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[1]:
        raise ValueError(f"conv2d: input {tuple(x.shape)} (NHWC) with "
                         f"filters {tuple(w.shape)} (OC, IC, KH, KW)")
    n, h, wd, ic = x.shape
    oc, _, kh, kw = w.shape
    if bias is not None and tuple(bias.shape) != (oc,):
        raise ValueError(f"conv2d: bias {tuple(bias.shape)} for OC={oc}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"conv2d: the kernel's epilogue has no "
                         f"{activation!r}; it takes {sorted(ACTIVATIONS)}")
    if stride < 1 or padding < 0:
        raise ValueError(f"conv2d: stride {stride}, padding {padding}")
    # floor division, as conv2d_pallas computes the output geometry
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw) // stride + 1
    if min(n, ic, oc, oh, ow) <= 0:
        raise ValueError(f"conv2d: empty output for input {tuple(x.shape)}, "
                         f"filters {tuple(w.shape)}, padding {padding}")
    if -(-n * oh * ow // TILE_M) > 65535:
        raise ValueError(f"conv2d: {n * oh * ow} output pixels exceed the "
                         f"grid's {65535 * TILE_M}")
    out = torch.empty((n, oh, ow, oc), dtype=x.dtype, device=device)
    # the kernel's pre-pass writes the filters here as TF32 (hi, lo) parts,
    # (OC, Kp) each, tap-major
    ws = torch.empty((2, oc, padded_k(ic, kh, kw)), dtype=torch.float32,
                     device=device)
    with _build.device_scope(device):
        _build.launch("repro_conv2d", _ARGTYPES, x.data_ptr(), w.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), ws.data_ptr(), n, h, wd, ic, oc, kh,
                      kw, oh, ow, stride, padding, ACTIVATIONS[activation],
                      _build.DTYPES[x.dtype], _build.stream(device))
    conv2d_cuda.launches += 1
    return out


conv2d_cuda.launches = 0
