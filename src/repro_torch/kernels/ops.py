"""Public wrappers around the Hopper kernels.

Each chooses by the device of the tensor it is given: a CUDA tensor launches
the hand-written kernel (whose wrapper raises on what the kernel does not
take), and a CPU tensor runs the plain PyTorch version in ``ref``.  No other
switch and no fallback: a CUDA tensor never takes the plain version.  The
signatures match the JAX package's ``kernels/ops.py``, so the execution-engine
registry (core/engines.py) builds against either the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .conv2d import conv2d_cuda
from .flash_attention import flash_attention_cuda
from .lrn import lrn_cuda
from .matmul import matmul_cuda
from .paged_attention import paged_attention_cuda
from .pooling import pool_cuda


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: str = "none") -> torch.Tensor:
    """(M, K) @ (K, N) [+ bias, activation] with fp32 accumulation."""
    if _on_cpu(x):
        return ref.fc_ref(x, w, bias, activation=activation)
    return matmul_cuda(x, w, bias, activation=activation)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: int = 0, activation: str = "none") -> torch.Tensor:
    """NHWC input, (OC, IC, KH, KW) filters."""
    if _on_cpu(x):
        return ref.conv2d_ref(x, w, bias, stride=stride, padding=padding,
                              activation=activation)
    return conv2d_cuda(x, w, bias, stride=stride, padding=padding,
                       activation=activation)


def pool(x: torch.Tensor, *, window: int = 3, stride: int = 2,
         pool_type: str = "max") -> torch.Tensor:
    """VALID max or average pooling, NHWC."""
    if _on_cpu(x):
        impl = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
        return impl(x, window=window, stride=stride)
    return pool_cuda(x, window=window, stride=stride, pool_type=pool_type)


def lrn(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """Across-channel LRN over the last axis; k defaults to 2.0."""
    if _on_cpu(x):
        return ref.lrn_ref(x, local_size=local_size, alpha=alpha, beta=beta,
                           k=k)
    return lrn_cuda(x, local_size=local_size, alpha=alpha, beta=beta, k=k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, HQ, S, D); k/v (B, HK, T, D); query i at key position
    i + q_offset, by default T - S (query ends aligned with key ends).  Any
    S and T: the kernel masks ragged tiles, so nothing is padded and no call
    is routed to the plain version."""
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                q_offset=q_offset)


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    pos: torch.Tensor, *,
                    max_seq: Optional[int] = None) -> torch.Tensor:
    """Decode attention of q (B, HQ, 1, D) over block arenas
    (TB, HK, BS, D) read through (B, NB) block tables, positions <= pos."""
    if _on_cpu(q):
        return ref.paged_attention_ref(q, k_arena, v_arena, block_tables,
                                       pos, max_seq=max_seq)
    return paged_attention_cuda(q.contiguous(), k_arena, v_arena,
                                block_tables.to(torch.int32).contiguous(),
                                pos.to(torch.int32).contiguous())


# FC layer matching the paper's Eq. 1 (vector-matrix + f)
def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
       activation: str = "none") -> torch.Tensor:
    """x (B, n_in); the FC engines flatten a layer's NHWC input first."""
    if activation == "softmax":  # softmax stays outside the GEMM kernel
        return torch.softmax(matmul(x, w, b, activation="none"), dim=-1)
    return matmul(x, w, b, activation=activation)
