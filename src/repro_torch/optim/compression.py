"""Int8 gradient compression with error feedback, the JAX package's.

Block-wise symmetric int8 quantization (blocks of 256 values, the flat
gradient zero-padded to a whole block, one fp32 scale per block), with the
quantization residual carried into the next step (Seide et al. 2014,
Karimireddy et al. 2019):

    q, scale   = quantize(g + e)
    g_hat      = dequantize(q)
    e'         = (g + e) - g_hat

``torch.round`` rounds half to even, as ``jnp.round`` does, so the port's
int8 values equal the JAX package's bit for bit.  Behind the trainer's
``--grad-compression int8``; the cross-pod all-reduce it compresses for
comes with the trainer across devices (ROADMAP §1 item 9b), so on one card
the dequantized gradients go straight to the optimizer.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_map

Tree = Any
_BLOCK = 256


def _pad_len(n: int) -> int:
    return (-n) % _BLOCK


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization.  Returns (q (nb, 256) int8,
    scales (nb, 1) fp32)."""
    flat = g.float().reshape(-1)
    blocks = F.pad(flat, (0, _pad_len(flat.numel()))).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compressed_allreduce_update(grads: Tree, error: Tree
                                ) -> Tuple[Tree, Tree]:
    """Quantize (grads + error) and return (dequantized grads, new error),
    the error written in place into ``error``'s tensors (PyTorch's idiom;
    the JAX package returns a new tree)."""
    def one(g, e):
        target = g.float() + e
        q, s = compress_int8(target)
        deq = decompress_int8(q, s, g.shape, torch.float32)
        e.copy_(target - deq)
        return deq.to(g.dtype)

    return tree_map(one, grads, error), error


def init_error(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
