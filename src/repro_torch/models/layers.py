"""Shared transformer layers: RMSNorm and LayerNorm, rotary embeddings, the
SwiGLU and GELU MLPs, the training loss, and the placement helpers the
layers call on DTensors (a plain tensor passes them unchanged).

Plain functions on tensors, with the JAX package's numerics: norms and rope
in fp32 and cast back to the input dtype, projections in the compute dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: None, one axis name or a tuple of them."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _splits(p, dim: int) -> bool:
    """Whether placement ``p`` splits tensor dim ``dim`` (a ``Shard``, or
    the strided shard a flattening view leaves)."""
    return getattr(p, "dim", None) == dim


def is_split(x: DTensor, dim: int) -> bool:
    """Whether a mesh dim splits tensor dim ``dim`` of ``x``."""
    return any(_splits(p, dim) for p in x.placements)


def _redistribute(x: DTensor, target) -> DTensor:
    """``x`` on the placements ``target(x's placements)``.  Made contiguous
    first: the redistribution's backward gives the gradient the forward
    input's strides, whatever the layout of its local part (and a copy may
    itself settle a partial sum, so the target is read after it)."""
    x = x.contiguous()
    return x.redistribute(x.device_mesh, target(x.placements))


def pin(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` redistributed so that tensor dim i is sharded over the mesh
    axes ``spec[i]`` and replicated over the others; a plain tensor is
    returned as it is (the constraint of a one-device run)."""
    if not isinstance(x, DTensor):
        return x
    placements = [Replicate()] * x.device_mesh.ndim
    for i, entry in enumerate(spec):
        for axis in spec_axes(entry):
            placements[x.device_mesh.mesh_dim_names.index(axis)] = Shard(i)
    return _redistribute(x, lambda _: placements)


def whole_if_uneven(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """A DTensor about to be split into (or just merged from) ``n`` heads
    on ``dim``, on a mesh with a dim whose size does not divide ``n``
    (qwen2's 12 heads on the 16-wide 'model' axis), redistributed whole
    on ``dim``: GSPMD pads such a split, DTensor refuses to view it.  The
    redistribution's backward puts the gradient on the same placements, so
    the view's backward meets no uneven split either.  Any other tensor is
    returned as it is."""
    if not isinstance(x, DTensor) or all(
            n % size == 0 for size in x.device_mesh.shape):
        return x
    return unshard(x, dim)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor redistributed whole on ``dim`` (each mesh dim that splits
    it replicates it instead); any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _redistribute(x, lambda placements: [
        Replicate() if _splits(p, dim) else p for p in placements])


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


class _SplitVocabNLL(torch.autograd.Function):
    """Token NLL in fp32 of logits that are a DTensor, on the logits'
    placements, a split vocab included, forward and backward: DTensor
    would place ``gather``'s backward (a scatter into a ``new_zeros``
    buffer) replicated, a whole (B, S, V) fp32 gradient on every device,
    and an elementwise backward where its operands leave it the choice.
    The log-sum-exp is taken about the row max (partial maxima and sums
    over a split vocab are reduced), the gold logit as a masked sum over
    the vocab (exact: every other term is a zero), and the gradient
    ``(softmax - onehot) * g`` follows the logits."""

    @staticmethod
    def forward(ctx, logits, labels):
        mesh, last = logits.device_mesh, logits.dim() - 1
        ctx.dtype = logits.dtype
        # a mesh dim that leaves the logits whole (a vocab no axis divides)
        # splits the sequence instead, a local slice, before the fp32 copy
        logits = logits.redistribute(mesh, [
            Shard(last - 1) if isinstance(p, Replicate)
            and logits.shape[last - 1] % size == 0 else p
            for p, size in zip(logits.placements, mesh.shape)]).float()
        # the vocab's ids split as the logits' vocab is (a local slice), so
        # that the one-hot mask is made split, never whole
        vocab = DTensor.from_local(
            torch.arange(logits.shape[-1], device=logits.device), mesh,
            [Replicate()] * mesh.ndim, run_check=False).redistribute(
                mesh, [Shard(0) if _splits(p, last) else Replicate()
                       for p in logits.placements])
        rows = [Replicate() if _splits(p, last) else p
                for p in logits.placements]
        if isinstance(labels, DTensor):
            labels = labels.redistribute(mesh, rows)
        hit = (labels.long().unsqueeze(-1) == vocab).redistribute(
            mesh, logits.placements)
        top = logits.amax(-1, keepdim=True)
        logz = (logits - top).exp().sum(-1).log() + top[..., 0]
        ctx.save_for_backward(logits, hit, logz)
        ctx.rows = rows
        return logz - torch.where(hit, logits, 0.0).sum(-1)

    @staticmethod
    def backward(ctx, g):
        logits, hit, logz = ctx.saved_tensors
        g = g.redistribute(logits.device_mesh, ctx.rows)
        grad = (logits - logz.unsqueeze(-1)).exp_()          # softmax
        grad = grad.sub_(hit.to(grad.dtype)).mul_(g.unsqueeze(-1))
        return grad.to(ctx.dtype), None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token NLL in fp32.  logits: (..., V); labels: int (...); an
    optional mask weights each token and the mean is over its sum (at
    least 1)."""
    if isinstance(logits, DTensor):
        nll = _SplitVocabNLL.apply(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
