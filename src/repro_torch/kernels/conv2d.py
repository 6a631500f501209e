"""Implicit-GEMM convolution kernel for Hopper — the Conv module (paper
Table III, 'Conv Layer').

Wraps ``csrc/conv2d.cu``, which replaces the JAX package's
``conv2d_pallas``: NHWC convolution with stride and zero padding, (OC, IC,
KH, KW) filters, fused bias and activation.  The kernel gathers patches
straight from the NHWC input, treating padding taps as zeros, so neither a
padded input nor an im2col matrix is made.  The plain version is
``ref.conv2d_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .matmul import ACTIVATIONS

SOURCE = "conv2d.cu"
_ARGTYPES = (_build.PTR,) * 4 + (_build.INT,) * 13 + (_build.PTR,)


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
    # tap-major filter matrix (KH, KW, IC, OC), as conv2d_pallas reshapes it:
    # the kernel then reads rows of OC contiguously
    w_mat = w.permute(2, 3, 1, 0).contiguous()
    out = torch.empty((n, oh, ow, oc), dtype=x.dtype, device=device)
    with _build.device_scope(device):
        _build.launch("repro_conv2d", _ARGTYPES, x.data_ptr(),
                      w_mat.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), n, h, wd, ic, oc, kh, kw, oh, ow,
                      stride, padding, ACTIVATIONS[activation],
                      _build.DTYPES[x.dtype], _build.stream(device))
    conv2d_cuda.launches += 1
    return out


conv2d_cuda.launches = 0
