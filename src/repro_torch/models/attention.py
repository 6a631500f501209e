"""Attention implementations — the transformer's engine axis.

Full-sequence attention (prefill), selected by ``ModelConfig.attention_impl``:

* ``dot``     — plain masked dot-product attention; materializes (S, T).
* ``chunked`` — the flash algorithm in plain PyTorch: an online softmax over
                key chunks, never more than (S, kv_chunk) scores at once.
                Forward only.
* ``hopper``  — the hand-written flash-attention kernel
                (kernels/flash_attention.py) through ``kernels.ops``.

Single-token decode attention against a dense cache (``decode_attention``)
or a block-paged arena (``paged_decode_attention``, impl ``ref`` or
``hopper``, selected by ``ModelConfig.paged_attention_impl``).

All take q: (B, HQ, S, D), k/v: (B, HK, T, D) with HQ % HK == 0 and fold the
GQA group into the query side, so KV is never repeated.  The JAX package's
impl name ``pallas`` is this package's ``hopper``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops as kops

_NEG_INF = -1e30


def _gqa_fold(q: torch.Tensor, hk: int) -> torch.Tensor:
    b, hq, s, d = q.shape
    return q.reshape(b, hk, hq // hk, s, d)


def _mask(s: int, qpos0: int, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(S, len(kpos)) validity of key positions for queries at qpos0 + i."""
    qpos = torch.arange(s, device=kpos.device)[:, None] + qpos0
    mask = torch.ones((s, kpos.shape[0]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window is not None:
        mask &= kpos[None, :] > qpos - window
    return mask


def dot_attention(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q_offset: absolute position of q[..., 0, :] relative to k's start."""
    b, hq, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    qg = _gqa_fold(q, hk).float()
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    mask = _mask(s, q_offset, torch.arange(t, device=q.device), causal,
                 window)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      kv_chunk: int = 2048) -> torch.Tensor:
    """The flash algorithm in plain PyTorch (forward only): a loop over key
    chunks with a running max, denominator and fp32 accumulator.  The last
    chunk may be short; nothing is padded."""
    b, hq, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = hq // hk
    bk = min(kv_chunk, t)
    qg = _gqa_fold(q, hk).float() * (1.0 / (d ** 0.5))     # (B,HK,G,S,D)
    m = torch.full((b, hk, g, s, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, hk, g, s, 1), device=q.device)
    acc = torch.zeros((b, hk, g, s, d), device=q.device)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        mask = _mask(s, 0, torch.arange(k0, k0 + kb.shape[2],
                                        device=q.device), causal, window)
        logits = torch.einsum("bkgsd,bktd->bkgst", qg, kb)
        logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new) * mask
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,bktd->bkgsd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, s, d).to(q.dtype)


def hopper_attention(q, k, v, *, causal: bool = True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Query i at key position i, as ``dot`` and ``chunked`` place it and
    the JAX package's ``pallas`` impl does."""
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=0)


def attend(q, k, v, *, impl: str = "dot", causal: bool = True,
           window: Optional[int] = None,
           kv_chunk: int = 2048) -> torch.Tensor:
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_chunk=kv_chunk)
    if impl == "hopper":
        return hopper_attention(q, k, v, causal=causal, window=window)
    if impl != "dot":
        raise ValueError(f"unknown attention impl {impl!r}")
    return dot_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, *, pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, HQ, 1, D); caches: (B, HK, T, D); ``pos``: the absolute position
    of the current token, a (B,) tensor of per-slot positions or a scalar.
    For windowed layers the cache is a rolling buffer of T == window slots.

    The JAX package's rule holds: q is cast to the cache dtype and the
    products are of cache-dtype values, summed in fp32 (the cache itself is
    never upcast in place).  In eager PyTorch the fp32 operands below are
    per-call temporaries of the rows this call contracts — exact widenings
    of the cache-dtype values, so the sums equal a cache-dtype contraction
    with fp32 accumulation.
    """
    b, hq, _, d = q.shape
    hk, t = k_cache.shape[1], k_cache.shape[2]
    qg = _gqa_fold(q, hk)[:, :, :, 0]                        # (B,HK,G,D)
    logits = torch.einsum("bkgd,bktd->bkgt",
                          qg.to(k_cache.dtype).float(),
                          k_cache.float()) * (1.0 / (d ** 0.5))
    slots = torch.arange(t, device=q.device)
    pos_a = torch.as_tensor(pos, device=q.device)
    cap = pos_a if window is None else torch.clamp(pos_a, max=t - 1)
    valid = slots <= cap[..., None]          # (t,) scalar | (B, t) per-slot
    mask = (valid[None, None, None] if valid.dim() == 1
            else valid[:, None, None, :])
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd",
                       probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_decode_attention(q, k_arena, v_arena, block_tables, pos, *,
                           max_seq: int, impl: str = "ref") -> torch.Tensor:
    """Single-token attention against a block-paged cache.

    q: (B, HQ, 1, D); arenas: (total_blocks + 1, HK, BS, D), the last page
    being the trash page inactive slots write to; block_tables: (B, NB)
    int32; pos: (B,) per-slot position of the current token.

    ``impl="ref"`` gathers each slot's rows through its table and runs
    :func:`decode_attention` on them: the same numbers as the dense slot
    cache.  ``impl="hopper"`` runs the paged-attention kernel, which reads
    the pages through the table itself (online softmax: close to ``ref``,
    not bit-identical).
    """
    if impl == "hopper":
        return kops.paged_attention(q, k_arena, v_arena, block_tables, pos,
                                    max_seq=max_seq).to(q.dtype)
    if impl != "ref":
        raise ValueError(f"unknown paged attention impl {impl!r}")
    from ..kernels.ref import paged_gather
    k = paged_gather(k_arena, block_tables, max_seq)
    v = paged_gather(v_arena, block_tables, max_seq)
    return decode_attention(q, k, v, pos=pos, window=None)
