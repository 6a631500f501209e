"""Paged decode-attention kernel for Hopper — the serving decode step's
attention over the block-paged KV arena.

Wraps ``csrc/paged_attention.cu``, which replaces the JAX package's
``paged_attention_pallas``: a single query token per slot attends over the
positions <= ``pos`` of that slot, whose keys and values live in the pages
its block-table row names; the GQA group of query heads shares each page
load, and an online softmax folds the pages together.  The plain version is
``ref.paged_attention_ref`` (gather through the table, then dense decode
attention).
"""
from __future__ import annotations

import torch

from . import _build

SOURCE = "paged_attention.cu"
_ARGTYPES = (_build.PTR,) * 6 + (_build.INT,) * 6 + (
    _build.FLOAT, _build.INT, _build.PTR)


def _check_index(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.int32
            or not t.is_contiguous() or tuple(t.shape) != shape):
        raise ValueError(f"paged_attention: {name} must be a contiguous "
                         f"int32 tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def paged_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                         v_arena: torch.Tensor, block_tables: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """q (B, HQ, 1, D); arenas (TB, HK, BS, D) with HQ % HK == 0, one dtype
    (float32 or bfloat16); block_tables (B, NB) and pos (B,) int32, all
    contiguous on one card.  Returns (B, HQ, 1, D) in q's dtype.

    Table entries past a slot's written pages are never read: the kernel
    walks only the pages holding positions <= pos.
    """
    device = _build.check_cuda("paged_attention", q, k_arena, v_arena)
    if q.dim() != 4 or q.shape[2] != 1 or k_arena.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"(B, HQ, 1, D), arenas {tuple(k_arena.shape)} "
                         "(TB, HK, BS, D)")
    b, hq, _, d = q.shape
    _, hk, bs, dk = k_arena.shape
    if (v_arena.shape != k_arena.shape or dk != d or hq % hk != 0
            or block_tables.dim() != 2 or block_tables.shape[0] != b):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, arenas "
                         f"{tuple(k_arena.shape)} / {tuple(v_arena.shape)}, "
                         f"block_tables {tuple(block_tables.shape)}")
    nb = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, nb), device)
    _check_index("pos", pos, (b,), device)
    out = torch.empty_like(q)
    with _build.device_scope(device):
        _build.launch("repro_paged_attention", _ARGTYPES, q.data_ptr(),
                      k_arena.data_ptr(), v_arena.data_ptr(),
                      block_tables.data_ptr(), pos.data_ptr(),
                      out.data_ptr(), b, hk, hq // hk, bs, d, nb, d ** -0.5,
                      _build.DTYPES[q.dtype], _build.stream(device))
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
