"""Flash-attention kernel for Hopper — causal (and sliding-window) GQA
prefill attention.

Wraps ``csrc/flash_attention.cu``, which replaces the JAX package's
``flash_attention_pallas``: an online softmax over key tiles, so the (S, T)
scores never reach device memory; tiles above the causal diagonal or left of
the window are skipped.  The kernel masks ragged edges itself, so the wrapper
pads nothing.  Query i sits at key position i + ``q_offset``: 0 aligns query
starts with key starts, as the Pallas kernel does; the default T - S aligns
query ends with key ends, as the plain version ``ref.attention_ref`` does by
default.  bfloat16 runs a tensor-core body (wgmma, K and
V streamed by TMA), float32 a CUDA-core body; both are hand-written.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

SOURCE = "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
_ARGTYPES = (_build.PTR,) * 4 + (_build.INT,) * 9 + (
    _build.FLOAT, _build.INT, _build.PTR)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, HQ, S, D); k/v (B, HK, T, D) with HQ % HK == 0 and D in
    ``HEAD_DIMS``; contiguous CUDA tensors of one dtype (float32 or
    bfloat16).  Query i sits at key position i + q_offset (default T - S).
    Returns (B, HQ, S, D) in q's dtype."""
    device = _build.check_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    _, hk, t, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hk != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel takes "
                         f"{HEAD_DIMS}")
    if min(b, s, t) == 0:
        raise ValueError(f"flash_attention: empty operand q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window}")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: bf16 operands must start on a "
                         "16-byte boundary (TMA reads them)")
    out = torch.empty_like(q)
    with _build.device_scope(device):
        _build.launch("repro_flash_attention", _ARGTYPES, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hk,
                      s, t, d, t - s if q_offset is None else q_offset,
                      int(causal), window or 0, d ** -0.5,
                      _build.DTYPES[q.dtype], _build.stream(device))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
