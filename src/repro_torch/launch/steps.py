"""Step builders: the train step of the trainer (loss and gradients of
``models.transformer.loss_fn``, gradient accumulation over microbatches,
optional int8 compression with error feedback, the optimizer's update) and
:func:`build_step`, the JAX package's ``launch/steps.py`` builder of one
registry cell's train, prefill or decode step with its shardings, which
the dry run traces on the production meshes.

    fn, in_sh, out_sh, donate, args = build_step(arch, shape_name, mesh)
    out = sharded(fn, in_sh, out_sh)(*placed_args)

:func:`sharded` is the counterpart of ``jax.jit(fn, in_shardings=,
out_shardings=)``: it places the arguments, runs ``fn`` eagerly under
``implicit_replication`` (positions, masks and tables are plain tensors)
and redistributes the outputs.  On the 1x1 host mesh every leaf is a plain
tensor and nothing is redistributed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import registry
from ..models import sharding as shard_lib
from ..models import transformer as T
from ..optim import adamw, compression, schedules
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


def _like(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``g`` on ``a``'s placements, for an in-place update of ``a`` (a
    DTensor's in-place op keeps its placements); a plain tensor as it
    is."""
    if isinstance(g, DTensor):
        return g.redistribute(a.device_mesh, a.placements)
    return g


def _accum_grads(params: Tree, cfg: T.ModelConfig, batch: Batch,
                 n: int) -> Tuple[torch.Tensor, Tree]:
    """Gradient accumulation over ``n`` sequential microbatches (every
    tensor of the batch split along its first axis, front-end embeddings
    too): sums loss / n and grads / n in fp32."""
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    grads_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
    # a batch sharded on its first axis is gathered whole first: its
    # microbatches are contiguous runs of rows, which DTensor cannot view
    # out of a split that does not divide them (the forward pins each
    # microbatch's activations again)
    batch = {k: T.unshard(v, 0) for k, v in batch.items()}
    for i in range(n):
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(params, cfg, micro)
        loss_acc = loss_acc + loss / n
        tree_map(lambda a, g: a.add_(_like(g, a) / n), grads_acc, grads)
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


# ---------------------------------------------------------------------------
# build_step: one registry cell's step with its shardings
# ---------------------------------------------------------------------------
def _schedule(name: str):
    """The schedule a cell's train step runs (the JAX package's
    ``build_step`` values; the train CLI keeps its own)."""
    if name == "wsd":
        return schedules.wsd_schedule(3e-4, 500, 8000, 1500)
    return schedules.cosine_schedule(3e-4, 500, 10000)


@functools.lru_cache(maxsize=64)
def _emitted_cache(arch: registry.ArchSpec, shape_name: str):
    """The cache a prefill step emits, as ``meta`` tensors, traced on the
    cell's meta arguments once per config and shape (its structure depends
    on neither the mesh nor the activation constraint); dot attention and
    one scan chunk emit the same cache in a fraction of the ops."""
    cfg = arch.config
    spec = registry.input_specs(arch, shape_name)
    extras = {k: spec[k] for k in ("enc_inputs", "img_embeds") if k in spec}
    trace_cfg = dataclasses.replace(
        cfg, attention_impl="dot",
        scan_chunk=registry.SHAPES[shape_name].seq_len)
    with torch.no_grad():
        return T.forward(shard_lib.meta_params(cfg), trace_cfg,
                         spec["tokens"], emit_cache=True, **extras)[1]


def _replicated(policy: shard_lib.ShardingPolicy):
    return policy.named((), ())


def build_step(arch: registry.ArchSpec, shape_name: str, mesh):
    """(fn, in_shardings, out_shardings, donate, abstract_args) of one
    cell: the train step ``(params, opt_state, batch) -> (params,
    opt_state, {loss, lr, grad_norm})`` over ``cfg.grad_accum``
    microbatches, the prefill step ``(params, tokens[, enc_inputs |
    img_embeds]) -> (last logits, cache)`` or the decode step ``(params,
    cache, tokens) -> (logits, cache)``.  The abstract arguments are
    ``meta`` tensors; ``mesh`` is a ``DeviceMesh`` (shardings are
    ``models.sharding.Sharding``) or a mocked one (specs).  The config's
    ``act_sharding`` pins activations to the batch/seq spec of the batch
    the forward sees, so a parameter's storage shard cannot take the
    batch's axis (ZeRO-3): the microbatch in training, the whole batch in
    prefill and decode.  (The JAX package resolves the microbatch in every
    mode; for an arch with ``grad_accum`` > 1 that leaves prefill's and
    decode's batch unsplit where the microbatch is too small for an axis,
    and every device of that axis repeats the whole batch's work.)"""
    cfg = arch.config
    shape = registry.SHAPES[shape_name]
    policy = shard_lib.make_policy(cfg, mesh)

    accum = max(cfg.grad_accum, 1)
    fwd_b = (max(shape.global_batch // accum, 1) if shape.mode == "train"
             else shape.global_batch)
    tok_spec = policy.resolve((fwd_b, shape.seq_len), ["batch", "seq"])
    cfg = dataclasses.replace(cfg, act_sharding=(tok_spec[0], tok_spec[1]))
    arch = dataclasses.replace(arch, config=cfg)

    p_shapes = shard_lib.meta_params(cfg)
    p_sh = shard_lib.param_shardings(cfg, policy, p_shapes)
    spec = registry.input_specs(arch, shape_name)

    if shape.mode == "train":
        o_shapes = adamw.adamw_init(p_shapes)
        b_sh = shard_lib.batch_shardings(cfg, policy, spec["batch"])
        _, update = adamw.make_optimizer(_schedule(arch.lr_schedule),
                                         decay=T.decay_mask(cfg))

        def train_step(params, opt_state, batch):
            if accum > 1:
                loss, grads = _accum_grads(params, cfg, batch, accum)
            else:
                loss, grads = loss_and_grads(params, cfg, batch)
            with torch.no_grad():
                new_p, new_o, metrics = update(grads, opt_state, params)
            return new_p, new_o, {"loss": loss, **metrics}

        metrics_sh = {k: _replicated(policy)
                      for k in ("loss", "lr", "grad_norm")}
        o_sh = adamw.AdamWState(step=_replicated(policy), mu=p_sh, nu=p_sh)
        return (train_step, (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh),
                (0, 1), (p_shapes, o_shapes, spec["batch"]))

    if shape.mode == "prefill":
        extras = [k for k in ("enc_inputs", "img_embeds") if k in spec]
        tok_sh = policy.named(tuple(spec["tokens"].shape), ["batch", "seq"])
        extra_sh = tuple(
            policy.named(tuple(spec[k].shape), ["batch", "seq", None])
            for k in extras)
        logits_sh = policy.named(
            (shape.global_batch, 1, cfg.vocab), ["batch", None, "vocab"])

        @torch.no_grad()
        def prefill_step(params, tokens, *extra):
            logits, cache = T.forward(params, cfg, tokens, emit_cache=True,
                                      **dict(zip(extras, extra)))
            return logits[:, -1:], cache

        abstract_args = (p_shapes, spec["tokens"]) + tuple(
            spec[k] for k in extras)
        cache_sh = shard_lib.cache_shardings(
            cfg, policy, _emitted_cache(
                dataclasses.replace(arch, config=dataclasses.replace(
                    cfg, act_sharding=None)), shape_name))
        return (prefill_step, (p_sh, tok_sh) + extra_sh,
                (logits_sh, cache_sh), (), abstract_args)

    cache_shapes = spec["cache"]
    cache_sh = shard_lib.cache_shardings(cfg, policy, cache_shapes)
    tok_sh = policy.named((shape.global_batch, 1), ["batch", None])
    logits_sh = policy.named(
        (shape.global_batch, 1, cfg.vocab), ["batch", None, "vocab"])

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return T.decode_step(params, cfg, cache, tokens)

    return (serve_step, (p_sh, cache_sh, tok_sh), (logits_sh, cache_sh),
            (1,), (p_shapes, cache_shapes, spec["tokens"]))


def _redistribute(t, s):
    if isinstance(t, DTensor):
        return t.redistribute(s.mesh, s.placements)
    return t


def sharded(fn: Callable, in_shardings, out_shardings) -> Callable:
    """``fn`` with its arguments placed on ``in_shardings``
    (``models.sharding.place``: DTensors on a multi-rank mesh, plain tensors
    on a one-device mesh's device; a leaf placed already is kept), run under
    ``implicit_replication`` (a plain tensor beside DTensors counts as
    replicated) and its outputs redistributed to ``out_shardings``."""
    def step(*args):
        placed = [shard_lib.place(a, s) for a, s in zip(args, in_shardings)]
        with implicit_replication():
            out = fn(*placed)
        return tree_map(_redistribute, out, out_shardings)

    return step
