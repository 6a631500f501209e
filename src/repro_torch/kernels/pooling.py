"""Pooling kernel for Hopper — the Pool module (paper Table III, 'Pooling').

Wraps ``csrc/pooling.cu``, which replaces the JAX package's ``pool_pallas``:
VALID max or average pooling over window x window taps at a stride, NHWC,
the average taken in fp32, a NaN tap making its max NaN.  The plain versions
are ``ref.maxpool_ref`` and ``ref.avgpool_ref``.
"""
from __future__ import annotations

import functools

import torch

from . import _build

SOURCE = "pooling.cu"
POOL_TYPES = ("max", "avg")
MAX_BAND = 16               # the most output rows a planned block covers
THREADS = 256               # threads per block (pooling.cu kThreads)
# shared memory a block may stage: as many blocks as fill an SM's 2048
# threads (eight) fit its 228 KB with 1 KB reserved for each
SMEM_BUDGET = 233_472 // (2048 // THREADS) - 1024
_ARGTYPES = (_build.PTR,) * 2 + (_build.INT,) * 13 + (_build.PTR,)


@functools.lru_cache(maxsize=256)
def plan(w: int, c: int, oh: int, ow: int, window: int, stride: int,
         elem_bytes: int) -> tuple[int, int, int]:
    """(band, owt, smem): each block covers ``band`` output rows and ``owt``
    output columns of one image and stages the input rows they read,
    ``smem`` bytes, in shared memory.  Of the tilings that fit SMEM_BUDGET,
    the one that stages the fewest bytes in all (neighbouring tiles share
    window - stride rows and columns), then the fewest blocks; if none fits,
    one output row a block, smem = 0: the kernel reads its taps from device
    memory."""
    def smem(band, owt):
        return (((band - 1) * stride + window) * ((owt - 1) * stride + window)
                * c * elem_bytes)

    best = None
    for owt in sorted({-(-ow // k) for k in range(1, ow + 1)}):
        for band in range(1, min(MAX_BAND, oh) + 1):
            size = smem(band, owt)
            if size > SMEM_BUDGET:
                continue
            blocks = -(-oh // band) * -(-ow // owt)
            key = (blocks * size, blocks)
            if best is None or key < best[0]:
                best = (key, (band, owt, size))
    if best is None:                    # one output row per block
        return 1, ow, 0
    return best[1]


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
    band, owt, smem = plan(w, c, oh, ow, window, stride, x.element_size())
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=device)
    with _build.device_scope(device):
        _build.launch("repro_pool", _ARGTYPES, x.data_ptr(), out.data_ptr(),
                      n, h, w, c, oh, ow, window, stride,
                      int(pool_type == "max"), band, owt, smem,
                      _build.DTYPES[x.dtype], _build.stream(device))
    pool_cuda.launches += 1
    return out


pool_cuda.launches = 0
