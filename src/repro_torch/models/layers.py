"""Shared transformer layers: RMSNorm and LayerNorm, rotary embeddings, the
SwiGLU and GELU MLPs, the training loss.

Plain functions on tensors, with the JAX package's numerics: norms and rope
in fp32 and cast back to the input dtype, projections in the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + weight), in fp32."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last axis, in
    fp32 (the biased variance, as ``jnp.var``)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S).  Rotates the
    two halves of the head dimension (the JAX package's layout)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up) @ w_down, weights cast to the compute
    dtype (a no-op for weights already held in it)."""
    h = F.silu(x @ w_gate.to(compute_dtype)) * (x @ w_up.to(compute_dtype))
    return h @ w_down.to(compute_dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: Optional[torch.Tensor],
             w_out: torch.Tensor, b_out: Optional[torch.Tensor],
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """gelu(x @ w_in + b_in) @ w_out + b_out, the biases optional, weights
    in the compute dtype; GELU's tanh form, as ``jax.nn.gelu``'s default."""
    h = x @ w_in.to(compute_dtype)
    if b_in is not None:
        h = h + b_in.to(compute_dtype)
    out = F.gelu(h, approximate="tanh") @ w_out.to(compute_dtype)
    if b_out is not None:
        out = out + b_out.to(compute_dtype)
    return out


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token NLL in fp32.  logits: (..., V); labels: int (...); an
    optional mask weights each token and the mean is over its sum (at
    least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
