"""Mixture-of-Experts FFN (mixtral, phi3.5-moe), the JAX package's routing.

Capacity-based routing (GShard semantics: per-sequence capacity, tokens past
an expert's capacity dropped) by scatter and gather over static shapes:

    slot(token, k) = expert_id · C + position-within-expert
    buffers        = scatter-add of tokens into (B, E·C + 1, D)
    experts        = batched FFN over (E, B, C, D)
    output         = gather back + gate-weighted sum over k

Every shape depends only on (B, S) and the config, and nothing reads a
device value on the host (no ``nonzero``, no masked indexing, no
``.item()``), so a decode step through this block can be captured as a
CUDA graph.  The expert products are plain batched matrix products: the JAX
package computes them outside any Pallas kernel.  In decode every slot is a
sequence of length 1, so each step runs all E experts over C = 8 rows per
slot and reads every expert's weights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def moe_param_shapes(args: MoEArgs) -> Dict[str, tuple]:
    """The JAX package's ``init_moe_params`` layout: the router (D, E) and
    the experts' SwiGLU weights stacked on a leading expert axis."""
    e, d, f = args.n_experts, args.d_model, args.d_ff
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def capacity(args: MoEArgs, seq: int) -> int:
    """Rows per expert for one sequence of ``seq`` tokens: at least 8, and
    a multiple of 8."""
    c = int(seq * args.top_k / args.n_experts * args.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              args: MoEArgs, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e, k = args.n_experts, args.top_k
    cap = capacity(args, s)
    n_slots = e * cap
    cd = compute_dtype

    logits = x.float() @ params["router"].float()             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # (B, S, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each routing slot within its expert's capacity buffer,
    # counted over the flattened (S·K) slots of each sequence, k fastest
    flat_e = gate_idx.reshape(b, s * k)
    onehot = (flat_e[..., None] == torch.arange(e, device=x.device)).to(
        torch.int32)                                          # (B, S·K, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_sel = (pos * onehot).sum(dim=-1)                      # (B, S·K)
    keep = pos_sel < cap
    flat_idx = torch.where(keep, flat_e * cap + pos_sel,
                           torch.full_like(pos_sel, n_slots))  # dump row

    # scatter tokens into expert buffers; a kept slot owns its row, so only
    # the dump row (cut away) ever sums more than one token
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d).to(cd)
    idx = flat_idx[..., None].expand(b, s * k, d)
    buf = torch.zeros((b, n_slots + 1, d), dtype=cd, device=x.device)
    buf.scatter_add_(1, idx, src)
    xin = buf[:, :n_slots].reshape(b, e, cap, d).transpose(0, 1) \
        .reshape(e, b * cap, d)                               # (E, B·C, D)

    h = F.silu(torch.bmm(xin, params["w_gate"].to(cd)))
    h = h * torch.bmm(xin, params["w_up"].to(cd))
    y = torch.bmm(h, params["w_down"].to(cd))                 # (E, B·C, D)

    # gather back and gate-combine (dropped slots read the zero dump row)
    y_flat = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, n_slots, d)
    y_flat = torch.cat([y_flat, y_flat.new_zeros((b, 1, d))], dim=1)
    tok = torch.gather(y_flat, 1, idx)                        # (B, S·K, D)
    w = (gate_vals.reshape(b, s * k) * keep).to(cd)
    out = (tok.reshape(b, s, k, d) * w.reshape(b, s, k, 1)).sum(dim=2)
    return out.to(x.dtype)
