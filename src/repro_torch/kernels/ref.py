"""Plain PyTorch versions of every kernel in this package.

They are what the kernels are held against (on the CPU in the tests, on the
card in ``chip_smoke.py``), what ``ops`` runs for a CPU tensor, and what the
``torch`` execution engine (core/engines.py) runs on any device.  Layouts
follow the JAX package: activations NHWC, filters (OC, IC, KH, KW) — the
paper's Table I order.  Every function returns a contiguous tensor, so a
kernel that follows a plain layer finds the layout it checks for.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fc_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           activation: str = "none") -> torch.Tensor:
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(x.dtype)


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    if activation == "tanh":
        return torch.tanh(y)
    if activation == "softmax":
        return torch.softmax(y, dim=-1)
    if activation == "none":
        return y
    raise ValueError(f"unknown activation {activation}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *, stride: int = 1,
               padding: int = 0, activation: str = "none") -> torch.Tensor:
    """NHWC input, (OC, IC, KH, KW) filters (paper Table I order).  The
    products stay fp32 on the card: PyTorch lets cuDNN round them to TF32
    by default (``torch.backends.cudnn.allow_tf32``), which this call turns
    off for itself."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = _nhwc(F.conv2d(_nchw(x.float()), w.float(), stride=stride,
                           padding=padding))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(x.dtype)


def maxpool_ref(x: torch.Tensor, *, window: int = 3,
                stride: int = 2) -> torch.Tensor:
    """VALID max pooling, NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def avgpool_ref(x: torch.Tensor, *, window: int = 3,
                stride: int = 2) -> torch.Tensor:
    """VALID average pooling, NHWC, summed in fp32."""
    return _nhwc(F.avg_pool2d(_nchw(x.float()), window, stride)).to(x.dtype)


def lrn_ref(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """Across-channel local response normalization (AlexNet / Caffe form):

        y = x / (k + (alpha/n) * sum_{window n} x^2) ** beta

    NHWC; the window runs over the channel axis, zero-padded at its edges.
    """
    sq = torch.square(x.float())
    half = local_size // 2
    padded = F.pad(sq, (half, half))
    c = x.shape[-1]
    acc = torch.zeros_like(sq)
    for i in range(local_size):
        acc = acc + padded[..., i:i + c]
    denom = torch.pow(k + (alpha / local_size) * acc, beta)
    return (x.float() / denom).to(x.dtype)


def paged_gather(arena: torch.Tensor, block_tables: torch.Tensor,
                 max_seq: int) -> torch.Tensor:
    """The dense per-slot KV rows a block table describes.

    arena: (total_blocks(+1), HK, BS, D) physical KV pages; block_tables:
    (B, NB) int32, block ``j`` of a slot holding tokens ``[j*BS, (j+1)*BS)``.
    Returns (B, HK, max_seq, D), trimmed to ``max_seq`` (NB*BS may overhang).
    The paged-attention kernel reads pages through the table instead of
    materializing these rows.
    """
    b, nb = block_tables.shape
    hk, bs, d = arena.shape[1:]
    rows = arena[block_tables.long()]                # (B, NB, HK, BS, D)
    rows = rows.permute(0, 2, 1, 3, 4).reshape(b, hk, nb * bs, d)
    return rows[:, :, :max_seq]


def paged_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                        v_arena: torch.Tensor, block_tables: torch.Tensor,
                        pos: torch.Tensor, *,
                        max_seq: Optional[int] = None) -> torch.Tensor:
    """Paged decode attention, plain: gather through the table, then the
    dense decode attention of ``models.attention``.

    q: (B, HQ, 1, D); arenas: (total_blocks(+1), HK, BS, D); block_tables:
    (B, NB) int32; pos: (B,) absolute position of each slot's current token
    (positions <= pos are attended).
    """
    from ..models.attention import decode_attention

    if max_seq is None:
        max_seq = block_tables.shape[1] * k_arena.shape[2]
    k = paged_gather(k_arena, block_tables, max_seq)
    v = paged_gather(v_arena, block_tables, max_seq)
    return decode_attention(q, k, v, pos=pos, window=None)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain multi-head attention in fp32.  q: (B, HQ, S, D); k/v:
    (B, HK, T, D); GQA by repeating KV heads.  Query i sits at key position
    i + q_offset; the default T - S aligns query ends with key ends, 0
    aligns their starts.  ``window``: each query attends to the last
    ``window`` keys, itself included.  A query with no key left to attend
    gets zeros.
    """
    b, hq, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (
        1.0 / (d ** 0.5))
    qpos = torch.arange(s, device=q.device)[:, None] + (
        t - s if q_offset is None else q_offset)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)
