"""Split-K pipelined GEMM kernel for Hopper — the FC module (paper Table
III, 'FC').

Wraps ``csrc/matmul.cu``, which replaces the JAX package's ``matmul_pallas``:
(M, K) @ (K, N) with an fp32 accumulator and a bias + relu / sigmoid / tanh
epilogue.  Edges are masked inside the kernel, so any M, N, K run without
padded copies.  :func:`split_k` cuts K so that a small batch still puts at
least two blocks on every SM; the wrapper allocates the fp32 partials, and
the kernel's second pass sums them in a fixed order (results are bitwise
repeatable).  The plain version is ``ref.fc_ref``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build

SOURCE = "matmul.cu"
ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ARGTYPES = (_build.PTR,) * 5 + (_build.INT,) * 7 + (_build.PTR,)

# the kernel's tile and ring (csrc/gemm_pipelined.cuh kTileM, kTileN,
# kTileK, kStages) and the card it fills
TILE_M, TILE_N, TILE_K = 64, 128, 16
STAGES = 4
SMS = 132                      # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2              # the fewest blocks per SM the split aims at
MIN_SLICE_STEPS = 4            # TILE_K steps per slice: the ring's depth


@functools.lru_cache(maxsize=256)
def split_k(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, slice_k): K cut into ``splits`` slices of ``slice_k`` (a
    multiple of TILE_K; the last may be shorter), covering [0, K) once.

    With fewer than BLOCKS_PER_SM * SMS output tiles, K is split until the
    grid reaches that many blocks, no slice shorter than MIN_SLICE_STEPS
    steps.  Among up to 1.5x that many splits, the one that leaves the
    least work on the busiest SM (waves of SMS blocks times steps per
    slice) wins, the fewest splits on a tie.
    """
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    steps = -(-k // TILE_K)
    target = BLOCKS_PER_SM * SMS
    most = max(1, steps // MIN_SLICE_STEPS)
    if tiles >= target or most == 1:
        return 1, steps * TILE_K
    fewest = min(most, -(-target // tiles))
    best = None
    for s in range(fewest, min(most, -(-3 * fewest // 2)) + 1):
        per = -(-steps // s)               # steps per slice
        splits = -(-steps // per)
        cost = (-(-tiles * splits // SMS) * per, splits)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2] * TILE_K


def smem_bytes(elem_bytes: int) -> int:
    """Dynamic shared memory of a block (gemm_pipelined.cuh smem_bytes):
    STAGES stages of an A tile (TILE_M x TILE_K) and a B tile (TILE_K x
    TILE_N) of ``elem_bytes`` elements."""
    return elem_bytes * STAGES * (TILE_M * TILE_K + TILE_K * TILE_N)


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
    splits, slice_k = split_k(m, n, k)
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=device)
          if splits > 1 else None)
    with _build.device_scope(device):
        _build.launch("repro_matmul", _ARGTYPES, x.data_ptr(), w.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                      m, n, k, splits, slice_k, ACTIVATIONS[activation],
                      _build.DTYPES[x.dtype], _build.stream(device))
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
