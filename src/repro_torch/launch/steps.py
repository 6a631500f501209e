"""The train step: loss and gradients of ``models.transformer.loss_fn``,
gradient accumulation over microbatches, optional int8 compression with
error feedback, and the optimizer's update (the JAX package's
``launch/steps.py`` train step and ``_accum_grads``).  The dry-run and
prefill step builders come with the sharding work (ROADMAP §1 item 9)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models import transformer as T
from ..optim import compression
from ..tree import tree_leaves, tree_map

Tree = Any
Batch = Dict[str, torch.Tensor]


def loss_and_grads(params: Tree, cfg: T.ModelConfig,
                   batch: Batch) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree beside ``params``): ``value_and_grad`` of
    ``loss_fn`` on the whole batch (``enc_inputs`` or ``img_embeds``
    included, for a cross-attention config).  The parameters are left as they are; each gradient comes
    in its leaf's dtype (fp32 for the fp32 masters), zeros for a leaf the
    loss does not reach."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = T.loss_fn(live, cfg, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))

    def grad(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad, live)


def _accum_grads(params: Tree, cfg: T.ModelConfig, batch: Batch,
                 n: int) -> Tuple[torch.Tensor, Tree]:
    """Gradient accumulation over ``n`` sequential microbatches (every
    tensor of the batch split along its first axis, front-end embeddings
    too): sums loss / n and grads / n in fp32."""
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
    for i in range(n):
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(params, cfg, micro)
        loss_acc = loss_acc + loss / n
        tree_map(lambda a, g: a.add_(g / n), grads_acc, grads)
        del grads
    return loss_acc, grads_acc


def make_train_step(cfg: T.ModelConfig, update: Callable, *,
                    grad_accum: int = 1) -> Callable:
    """``train_step(params, opt_state, err, batch) -> (params, opt_state,
    err, metrics)``: the gradients of one batch (over ``max(grad_accum,
    cfg.grad_accum)`` microbatches), compressed with error feedback when
    ``err`` is an error tree (``compression.init_error``), then
    ``update(grads, opt_state, params)`` (``optim.make_optimizer``, in
    place: the returned params, state and error are the given tensors,
    updated).  metrics: ``loss``, ``lr``, ``grad_norm``, as device
    scalars."""
    accum = max(grad_accum, cfg.grad_accum)

    def train_step(params, opt_state, err, batch):
        if accum > 1:
            loss, grads = _accum_grads(params, cfg, batch, accum)
        else:
            loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            if err is not None:
                grads, err = compression.compressed_allreduce_update(grads,
                                                                     err)
            new_p, new_o, metrics = update(grads, opt_state, params)
        return new_p, new_o, err, {"loss": loss, **metrics}

    return train_step
