"""AdamW with decoupled weight decay and global-norm clipping, over any
tree of tensors (the JAX package's, with no optimizer library).

In place, PyTorch's idiom, where the JAX package returns new trees:
``adamw_update`` writes the new parameters, moments and step into the
tensors it is given and returns them, and applies the clipping scale leaf
by leaf.  A functional step of a 1.5 B-parameter model would hold a second
copy of the parameters, both moments and the clipped gradients (~25 GB).
The arithmetic, and so every number, is the JAX package's.  Which leaves
are decayed is a tree of bools beside the parameters; without one, a leaf
of ndim >= 2 is.  For the transformer, ``models.transformer.decay_mask``
gives the JAX package's set, which is taken on its stacked layer layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..tree import tree_leaves, tree_map

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def adamw_init(params: Tree) -> AdamWState:
    """Zero fp32 moments beside each leaf, step 0 on the first leaf's
    device."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 lr: torch.Tensor, cfg: AdamWConfig,
                 decay: Optional[Tree] = None
                 ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One step, in place: (params, state, the gradients' global norm
    before clipping), params and state being the given ones, updated.
    ``decay``: a tree of bools beside ``params`` (None: decay the leaves of
    ndim >= 2)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    state.step.add_(1)
    b1c = 1 - cfg.b1 ** state.step.float()
    b2c = 1 - cfg.b2 ** state.step.float()

    def upd(p, g, m, v, d):
        g = (g if scale is None else g * scale).float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if d:                           # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, params, grads, state.mu, state.nu, decay)
    return params, state, gnorm


def make_optimizer(schedule: Callable, cfg: Optional[AdamWConfig] = None,
                   decay: Optional[Tree] = None):
    """(init_fn, update_fn(grads, state, params) -> (params, state,
    metrics)): the pair the train loop consumes, the update in place.
    ``decay`` as in :func:`adamw_update`."""
    cfg = cfg or AdamWConfig()

    def update(grads, state, params):
        lr = schedule(state.step)
        new_p, new_s, gnorm = adamw_update(grads, state, params, lr, cfg,
                                           decay)
        return new_p, new_s, {"lr": lr, "grad_norm": gnorm}

    return adamw_init, update
