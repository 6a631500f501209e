"""Tiled GEMM kernel for Hopper — the FC module (paper Table III, 'FC').

Wraps ``csrc/matmul.cu``, which replaces the JAX package's ``matmul_pallas``:
(M, K) @ (K, N) with an fp32 accumulator and a fused bias + relu / sigmoid /
tanh epilogue.  Edges are masked inside the kernel, so any M, N, K run
without padded copies.  The plain version is ``ref.fc_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

SOURCE = "matmul.cu"
ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ARGTYPES = (_build.PTR,) * 4 + (_build.INT,) * 5 + (_build.PTR,)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                activation: str = "none") -> torch.Tensor:
    """act(x @ w + bias) on the card; x (M, K), w (K, N), bias (N,), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16)."""
    device = _build.check_cuda("matmul", x, w, bias)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} for N={n}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"matmul: the kernel's epilogue has no {activation!r}"
                         f"; it takes {sorted(ACTIVATIONS)}")
    if min(m, n, k) == 0:
        raise ValueError(f"matmul: empty operand {(m, k)} @ {(k, n)}")
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    with torch.cuda.device(device):
        _build.launch("repro_matmul", _ARGTYPES, x.data_ptr(), w.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), m, n, k, ACTIVATIONS[activation],
                      _build.DTYPES[x.dtype], _build.stream(device))
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
