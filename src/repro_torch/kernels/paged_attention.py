"""Paged decode-attention kernel for Hopper — the serving decode step's
attention over the block-paged KV arena.

Wraps ``csrc/paged_attention.cu``, which replaces the JAX package's
``paged_attention_pallas``: a single query token per slot attends over the
positions <= ``pos`` of that slot, whose keys and values live in the pages
its block-table row names; the GQA group of query heads shares each page
load.  Each slot's pages are split into runs of ``PAGES_PER_SPLIT``, one
block each; a second kernel merges a slot's partial softmax sums in split
order, from a workspace this wrapper allocates, so a slot's output does not
depend on what it is batched with.  The plain version is
``ref.paged_attention_ref`` (gather through the table, then dense decode
attention).
"""
from __future__ import annotations

import torch

from . import _build

SOURCE = "paged_attention.cu"
_ARGTYPES = (_build.PTR,) * 7 + (_build.INT,) * 6 + (
    _build.FLOAT, _build.INT, _build.PTR)
# the kernel's split (csrc/paged_attention.cu kPagesPerSplit)
PAGES_PER_SPLIT = 4
SMEM_LIMIT = 232448            # bytes of shared memory a block may use


def splits(nb: int) -> int:
    """Blocks per (slot, kv head): the table width cut into splits."""
    return -(-nb // PAGES_PER_SPLIT)


def split_pages(pos: int, bs: int, nb: int, split: int) -> range:
    """The pages block ``split`` of a slot at ``pos`` reads, as the kernel
    computes them: those holding positions <= pos, at most ``nb``, in runs
    of PAGES_PER_SPLIT; empty for a split past the last page."""
    n_pages = 0 if pos < 0 else min(nb, pos // bs + 1)
    first = split * PAGES_PER_SPLIT
    return range(first, min(first + PAGES_PER_SPLIT, n_pages))


def smem_bytes(group: int, bs: int, d: int, elem: int) -> int:
    """Dynamic shared memory of a split block: the split's K and V pages,
    the group's fp32 query rows and scores."""
    keys = PAGES_PER_SPLIT * bs
    return 2 * keys * d * elem + group * d * 4 + group * keys * 4


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

    Pages past a slot's position are never dereferenced: the kernel loads
    only the pages holding positions <= pos, whatever the table's later
    entries hold.
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
    group = hq // hk
    if (d * q.element_size()) % 16 or any(
            a.data_ptr() % 16 for a in (k_arena, v_arena)):
        raise ValueError(f"paged_attention: rows of D={d} {q.dtype} must be "
                         "16-byte multiples on 16-byte aligned arenas (the "
                         "kernel copies pages in 16-byte chunks)")
    if smem_bytes(group, bs, d, q.element_size()) > SMEM_LIMIT:
        raise ValueError(f"paged_attention: pages of {bs} x {d} with a group "
                         f"of {group} need more than {SMEM_LIMIT} bytes of "
                         "shared memory per split")
    out = torch.empty_like(q)
    ws = torch.empty((b * hk * splits(nb) * group * (d + 2),),
                     dtype=torch.float32, device=device)
    with _build.device_scope(device):
        _build.launch("repro_paged_attention", _ARGTYPES, q.data_ptr(),
                      k_arena.data_ptr(), v_arena.data_ptr(),
                      block_tables.data_ptr(), pos.data_ptr(),
                      out.data_ptr(), ws.data_ptr(), b, hk, group, bs, d, nb,
                      d ** -0.5, _build.DTYPES[q.dtype],
                      _build.stream(device))
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
