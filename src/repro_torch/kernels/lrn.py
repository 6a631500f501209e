"""LRN kernel for Hopper — the Norm module (paper Table III, 'LRN').

Wraps ``csrc/lrn.cu``, which replaces the JAX package's ``lrn_pallas``:

    y = x / (k + (α/n) · Σ_{window n over channels} x²) ^ β

NHWC; channel c's window is [c - n//2, c - n//2 + n), for odd and even n,
zero-padded at the edges; computed in fp32.  The default k is 2.0, as in
the JAX package (PyTorch's own ``F.local_response_norm`` defaults to 1.0).
The plain version is ``ref.lrn_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = "lrn.cu"
_ARGTYPES = ((_build.PTR,) * 2 + (ctypes.c_longlong,) + (_build.INT,) * 2
             + (_build.FLOAT,) * 3 + (_build.INT, _build.PTR))
# threads per block and the widest window of the vector kernels
# (csrc/lrn.cu kThreads, kMaxN)
THREADS, MAX_N = 256, 9


def smem_bytes(c: int, n: int, elem_bytes: int) -> int:
    """Dynamic shared memory of a block of the vector kernel (csrc/lrn.cu
    launch_vec): one zero-padded fp32 row of squares per pixel of the block
    (Row<N>::floats), plus 4 floats; 0 where C or n sends the call to the
    plain kernel (16-byte aligned pointers assumed)."""
    vec = 16 // elem_bytes
    if c % vec or c // vec > THREADS or n > MAX_N:
        return 0
    off = (n // 2 + 3) // 4 * 4
    floats = (off + c + n - 1 - n // 2 + 3) // 4 * 4
    return (THREADS // (c // vec) * floats + 4) * 4


def lrn_cuda(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1e-4,
             beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """x (..., C), channels last: a contiguous CUDA tensor, float32 or
    bfloat16."""
    device = _build.check_cuda("lrn", x)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"lrn: empty input {tuple(x.shape)}")
    if local_size < 1:
        raise ValueError(f"lrn: local_size {local_size}")
    c = x.shape[-1]
    out = torch.empty_like(x)
    with _build.device_scope(device):
        _build.launch("repro_lrn", _ARGTYPES, x.data_ptr(), out.data_ptr(),
                      x.numel() // c, c, local_size, k, alpha / local_size,
                      beta, _build.DTYPES[x.dtype], _build.stream(device))
    lrn_cuda.launches += 1
    return out


lrn_cuda.launches = 0
