"""Attention implementations — the transformer's engine axis.

Full-sequence attention (prefill), selected by ``ModelConfig.attention_impl``:

* ``dot``     — plain masked dot-product attention; materializes (S, T).
* ``chunked`` — the flash algorithm in plain PyTorch: an online softmax over
                key chunks, never more than (S, kv_chunk) scores at once,
                with the flash backward (``ChunkedAttention``).
* ``hopper``  — the hand-written flash-attention kernel
                (kernels/flash_attention.py) through ``kernels.ops``.
                Forward only, as the JAX package's Pallas kernel: asking
                for a gradient through it raises.

Single-token decode attention against a dense cache (``decode_attention``)
or a block-paged arena (``paged_decode_attention``, impl ``ref`` or
``hopper``, selected by ``ModelConfig.paged_attention_impl``), and its
M-token form for the draft's catch-up (``decode_attention_multi``,
``paged_decode_attention_multi``: the gather path only, as in the JAX
package, which has no kernel for it either).

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


def _chunked_fwd(q, k, v, causal: bool, window: Optional[int], bk: int):
    """Online-softmax forward over key chunks of ``bk`` (the last may be
    short; nothing is padded).  Returns (out (B,HK,G,S,D) fp32, lse
    (B,HK,G,S,1), 0 for a row with no valid key)."""
    b, hq, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = hq // hk
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
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, 0.0, m + torch.log(l_safe))
    return acc / l_safe, lse


class ChunkedAttention(torch.autograd.Function):
    """The flash algorithm with the flash backward: the forward saves (q, k,
    v, out, lse), O(S) residuals, and the backward recomputes each key
    chunk's probabilities from the lse and sums dq, dk and dv in fp32 (the
    JAX package's ``_cv_fwd`` / ``_cv_bwd``).  dk and dv cover exactly the
    T key rows; the short last chunk is sliced, not padded."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                kv_chunk: int):
        b, hq, s, d = q.shape
        bk = min(kv_chunk, k.shape[2])
        out, lse = _chunked_fwd(q, k, v, causal, window, bk)
        ctx.save_for_backward(q, k, v, out.to(q.dtype), lse)
        ctx.causal, ctx.window, ctx.bk = causal, window, bk
        return out.reshape(b, hq, s, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, bk = ctx.causal, ctx.window, ctx.bk
        b, hq, s, d = q.shape
        hk, t = k.shape[1], k.shape[2]
        scale = 1.0 / (d ** 0.5)
        qg = _gqa_fold(q, hk).float() * scale                # (B,HK,G,S,D)
        dof = _gqa_fold(dout, hk).float()                    # (B,HK,G,S,D)
        delta = torch.sum(dof * out.float(), dim=-1, keepdim=True)
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for k0 in range(0, t, bk):
            kb = k[:, :, k0:k0 + bk].float()
            vb = v[:, :, k0:k0 + bk].float()
            mask = _mask(s, 0, torch.arange(k0, k0 + kb.shape[2],
                                            device=q.device), causal, window)
            logits = torch.einsum("bkgsd,bktd->bkgst", qg, kb)
            p = torch.exp(torch.where(mask, logits, _NEG_INF) - lse) * mask
            dvs.append(torch.einsum("bkgst,bkgsd->bktd", p, dof))
            dp = torch.einsum("bkgsd,bktd->bkgst", dof, vb)
            ds = p * (dp - delta)                            # d(logits)
            dq = dq + torch.einsum("bkgst,bktd->bkgsd", ds, kb) * scale
            dks.append(torch.einsum("bkgst,bkgsd->bktd", ds, qg))
        return (dq.reshape(b, hq, s, d).to(q.dtype),
                torch.cat(dks, dim=2).to(k.dtype),
                torch.cat(dvs, dim=2).to(v.dtype), None, None, None)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      kv_chunk: int = 2048) -> torch.Tensor:
    """The flash algorithm in plain PyTorch: a loop over key chunks with a
    running max, denominator and fp32 accumulator, differentiable through
    :class:`ChunkedAttention`'s flash backward."""
    return ChunkedAttention.apply(q, k, v, causal, window, kv_chunk)


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "attention_impl 'hopper' has no backward: the flash-attention "
                "kernel is forward only, in the JAX package too (its Pallas "
                "kernel has no VJP); train with attention_impl 'chunked' or "
                "'dot'")
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


def decode_attention_multi(q, k_cache, v_cache, *,
                           pos: torch.Tensor) -> torch.Tensor:
    """M-token attention against a cache (the draft's catch-up).

    q: (B, HQ, M, D); caches: (B, HK, T, D).  ``pos`` is a (B,) tensor of
    per-slot absolute positions of the FIRST query token: query m of slot b
    sits at position pos[b] + m and attends over cache slots <= pos[b] + m
    (the cache must already hold the window's K/V at positions
    pos..pos+M-1).  This is :func:`decode_attention` with a query axis,
    the offsets on the batch side of the products: (B, M, HK) products of
    (G, D) @ (D, T) in one call.  Windowed layers are unsupported: the
    rolling buffer's write-back overlaps itself inside one multi-token
    window.
    """
    b, hq, m, d = q.shape
    hk, t = k_cache.shape[1], k_cache.shape[2]
    qg = _gqa_fold(q, hk).permute(0, 3, 1, 2, 4)            # (B,M,HK,G,D)
    k_rows = k_cache.float()[:, None].expand(b, m, hk, t, d)
    v_rows = v_cache.float()[:, None].expand(b, m, hk, t, d)
    logits = torch.einsum("bmkgd,bmktd->bmkgt",
                          qg.to(k_cache.dtype).float(),
                          k_rows) * (1.0 / (d ** 0.5))
    slots = torch.arange(t, device=q.device)
    qpos = pos[:, None] + torch.arange(m, device=q.device)  # (B, M)
    valid = slots[None, None] <= qpos[:, :, None]            # (B, M, T)
    logits = torch.where(valid[:, :, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bmkgt,bmktd->bmkgd",
                       probs.to(v_cache.dtype).float(), v_rows)
    return out.reshape(b, m, hq, d).transpose(1, 2).to(q.dtype)


def paged_decode_attention_multi(q, k_arena, v_arena, block_tables, pos, *,
                                 max_seq: int) -> torch.Tensor:
    """M-token attention against a block-paged cache (the catch-up).

    Shapes as :func:`paged_decode_attention` with q: (B, HQ, M, D).  Only
    the gather path exists, on the CPU and on a card alike: the gathered
    rows equal the dense layout's at every attended position, and the JAX
    package's counterpart reaches no Pallas kernel either (a fused
    multi-query kernel is a follow-on there).
    """
    from ..kernels.ref import paged_gather
    k = paged_gather(k_arena, block_tables, max_seq)
    v = paged_gather(v_arena, block_tables, max_seq)
    return decode_attention_multi(q, k, v, pos=pos)
