"""The config-driven transformer family: dense llama-style decoders (qwen2,
deepseek-coder, granite, minicpm), the MoE decoders (mixtral, phi3.5-moe;
``models/moe.py``), the Mamba-1 decoder (falcon-mamba; ``models/ssm.py``),
the RG-LRU hybrid (recurrentgemma), the encoder-decoder (seamless-m4t: an
encoder over precomputed frame embeddings, and a cross-attention branch in
every decoder layer) and the vision decoder (llama-3.2-vision: a gated
cross-attention layer over precomputed patch embeddings every Nth layer).
Full-sequence forward (training shape and prefill), the decode step over a
dense cache (the static server's; a rolling buffer for windowed configs),
the slot decode steps the serving engine runs, on the dense slot cache and
on the block-paged one, and the block-paged M-token step that speculative
decoding verifies with.  Training reads ``loss_fn`` (differentiable in
every leaf, each layer recomputed in the backward under ``remat``) and
``decay_mask`` (the leaves AdamW decays).

Plain functions on explicit parameters, as in the JAX package: ``params`` is
a dict holding ``embed`` (V, D), ``final_norm`` (D,), ``layers`` — one dict
per layer, by the layer's type: ``attn`` layers hold ``ln1``, ``attn``
(``wq wk wv wo`` [+ ``bq bk bv``]), ``ln2`` and ``mlp`` (``w_gate w_up
w_down``, or the MoE's ``router`` and expert stacks), and in an
encoder-decoder's decoder ``lnx`` and ``xattn`` (``wq wk wv wo``) as well;
``xattn`` layers hold ``ln1``, ``xattn``, ``ln2``, ``mlp`` and the scalar
gates ``gate_attn`` and ``gate_mlp``; ``rec`` layers hold ``ln1``, ``rec``
(the RG-LRU branch), ``ln2`` and ``mlp``; ``mamba`` layers hold ``ln1`` and
``mamba`` — ``lm_head`` when embeddings are untied, and for an
encoder-decoder ``encoder`` (a list of ``attn`` layers) and
``enc_final_norm``.  The JAX package stacks layers for ``lax.scan``;
``models.convert.params_from_numpy`` unstacks its tree into this layout.

A cache holds one entry per layer: ``{"k", "v"}`` rows (dense) or arenas
(paged) for an attention layer, ``{"rec": {"h", "conv"}}`` or ``{"mamba":
{"h", "conv"}}`` for a recurrent one, ``{}`` for a cross-attention layer,
slot-major in either layout; a config with cross-attention adds ``cross``,
the features its cross-attention reads, (B, T, D) in the compute dtype (the
encoder's output, or the image embeddings).  Unlike the JAX package's pure
functions, the decode steps update the cache in place (the KV rows or
arenas, the recurrent states, the positions): it is the serving engine's
state, copying a 28-layer cache every token would double the step's
traffic, and a CUDA graph replaying the step reads and writes the same
buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..tree import tree_leaves
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (apply_rope, gelu_mlp, is_split, pin, rmsnorm,
                     softmax_cross_entropy, spec_axes, swiglu, unshard,
                     whole_if_uneven)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab: int = 32000
    head_dim: int = 0                       # 0 -> d_model // n_heads
    qkv_bias: bool = False
    gated_mlp: bool = True                  # SwiGLU (3 mats) vs plain (2)
    attn_window: Optional[int] = None       # SWA width (None = full)
    block_pattern: Tuple[str, ...] = ("attn",)   # unit: attn|rec|mamba|xattn
    cross_attn_every: int = 0               # vision: xattn every Nth layer
    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    scan_chunk: int = 256
    # encoder-decoder
    encoder_decoder: bool = False
    enc_layers: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    attention_impl: str = "chunked"         # dot | chunked | hopper
    attn_chunk: int = 1024
    # paged serving decode: "ref" (gather + dense decode attention) or
    # "hopper" (the paged-attention kernel, pages read through the table)
    paged_attention_impl: str = "ref"
    # training: recompute each layer's activations in the backward
    # (torch.utils.checkpoint per layer; changes no number), and split the
    # batch into this many sequential microbatches per step (gradient
    # accumulation)
    remat: bool = True
    frontend: str = "none"                  # none | audio | vision
    img_seq: int = 6404                     # vision stub: 4 tiles x 1601
    grad_accum: int = 1
    # activation sharding constraint (batch_axes, seq_axes), mesh axis names
    # set by launch.steps.build_step: pins (B, S, D) activations on a
    # DTensor mesh, so a parameter's storage shard cannot take the batch's
    # axis (ZeRO-3); a plain tensor passes unchanged
    act_sharding: Optional[Tuple[Any, Any]] = None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def pattern_unit(self) -> Tuple[str, ...]:
        if self.cross_attn_every > 0:
            return tuple(["attn"] * (self.cross_attn_every - 1) + ["xattn"])
        return self.block_pattern

    def layer_types(self) -> List[str]:
        unit = self.pattern_unit()
        return [unit[i % len(unit)] for i in range(self.n_layers)]

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.pattern_unit())

    def mamba_args(self) -> ssm_lib.MambaArgs:
        return ssm_lib.MambaArgs(self.d_model, self.ssm_state, self.ssm_conv,
                                 self.ssm_expand, self.scan_chunk)

    def rglru_args(self) -> ssm_lib.RGLRUArgs:
        return ssm_lib.RGLRUArgs(self.d_model, self.ssm_conv, self.ssm_expand,
                                 chunk=self.scan_chunk)

    def moe_args(self) -> moe_lib.MoEArgs:
        return moe_lib.MoEArgs(self.d_model, self.d_ff, self.n_experts,
                               self.moe_top_k, self.capacity_factor)


RECURRENT = ("rec", "mamba")


def _norm_in(x: torch.Tensor, weight: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The normed input of a block's projections.  On a DTensor the
    sequence is then gathered whole (Megatron's sequence parallelism): a
    product flattens (B, S) into rows, and rows split over a batch and a
    sequence mesh dim at once form a strided layout, whose redistributions
    DTensor plans by a search over the placements of every mesh dim, for
    minutes per op on the multipod mesh."""
    return unshard(rmsnorm(x, weight, cfg.norm_eps), 1)


def _gathered(p, cfg: ModelConfig):
    """A layer's parameters (a tree, or one tensor) for its products: on a
    DTensor mesh each weight is gathered whole over the mesh dims of the
    batch axes, ZeRO-3's all-gather (its backward reduce-scatters the
    gradients onto the storage shards), so the products take their natural
    layouts, rows split by batch and columns by 'model', and no storage
    shard competes with the batch for a mesh dim.  Plain tensors pass
    unchanged."""
    if cfg.act_sharding is None:
        return p
    axes = spec_axes(cfg.act_sharding[0])

    def gather(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        return t.redistribute(t.device_mesh, [
            Replicate() if names[i] in axes else pl
            for i, pl in enumerate(t.placements)])

    return map_params(lambda _, t: gather(t), p)


def _seq_split(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Queries (B, H, S, D) on a DTensor mesh split on the sequence over
    the activation constraint's sequence axes, in place of the heads where
    those axes split them: each device attends for its own queries against
    the whole keys, the sequence parallelism GSPMD gives the JAX package
    (:func:`_norm_in` gathered the sequence for the projections).  Heads
    split by the sequence's axis would make the products' (batch, heads)
    rows a strided layout, which DTensor may settle by repeating the
    attention on every device of that axis.  The caller gathers the output
    again.  Any other tensor as it is."""
    if (cfg.act_sharding is None or not isinstance(q, DTensor)
            or q.shape[2] == 1):
        return q
    names = q.device_mesh.mesh_dim_names
    seq = spec_axes(cfg.act_sharding[1])
    return q.contiguous().redistribute(q.device_mesh, [
        Shard(2) if names[i] in seq and (isinstance(p, Replicate)
                                         or getattr(p, "dim", None) == 1)
        else p for i, p in enumerate(q.placements)])


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, a block's branch ``y`` added to the residual stream.  On a
    DTensor the branch is first pinned whole on the sequence, as
    :func:`_norm_in` computed it: nothing moves in the forward, and the
    gradient reaching the branch is gathered too, so its backward products
    meet no strided layout either."""
    return x + unshard(y, 1)


def _constrain_act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin (B, S, D) activations to the policy's batch/seq sharding
    (``cfg.act_sharding``; the sequence's only while S > 1)."""
    if cfg.act_sharding is None:
        return x
    b_ax, s_ax = cfg.act_sharding
    return pin(x, (b_ax, s_ax if x.shape[1] > 1 else None, None))


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``enc_layers`` (default ``n_layers``)
    self-attention layers, no cross-attention."""
    return dataclasses.replace(
        cfg, n_layers=cfg.enc_layers or cfg.n_layers, block_pattern=("attn",),
        cross_attn_every=0, encoder_decoder=False)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _attn_shapes(cfg: ModelConfig, cross: bool = False) -> Params:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
            "wo": (h * hd, d)}
    if cfg.qkv_bias and not cross:
        attn.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
    return attn


def _block_shapes(cfg: ModelConfig, btype: str,
                  with_cross: bool = False) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.n_experts > 0:
        mlp = moe_lib.moe_param_shapes(cfg.moe_args())
    else:
        mlp = {"w_up": (d, f), "w_down": (f, d)}
        if cfg.gated_mlp:
            mlp["w_gate"] = (d, f)
    if btype == "attn":
        block = {"ln1": (d,), "attn": _attn_shapes(cfg), "ln2": (d,),
                 "mlp": mlp}
        if with_cross:
            block.update(lnx=(d,), xattn=_attn_shapes(cfg, cross=True))
        return block
    if btype == "xattn":
        return {"ln1": (d,), "xattn": _attn_shapes(cfg, cross=True),
                "ln2": (d,), "mlp": mlp, "gate_attn": (), "gate_mlp": ()}
    if btype == "rec":
        return {"ln1": (d,),
                "rec": ssm_lib.rglru_param_shapes(cfg.rglru_args()),
                "ln2": (d,), "mlp": mlp}
    if btype == "mamba":
        return {"ln1": (d,),
                "mamba": ssm_lib.mamba_param_shapes(cfg.mamba_args())}
    raise ValueError(btype)


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes, in the layout this module reads."""
    d = cfg.d_model
    shapes: Params = {"embed": (cfg.vocab, d), "final_norm": (d,),
                      "layers": [_block_shapes(cfg, t, cfg.encoder_decoder)
                                 for t in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    if cfg.encoder_decoder:
        enc = encoder_config(cfg)
        shapes["encoder"] = [_block_shapes(enc, t)
                             for t in enc.layer_types()]
        shapes["enc_final_norm"] = (d,)
    return shapes


def map_params(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over every leaf of a parameter tree (dicts and
    lists), ``name`` being the leaf's dict key; same structure out."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v, name) for v in tree]
    return fn(name, tree)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Params:
    """Random parameters from ``seed``, drawn on ``device``: He-normal
    matrices (fan-in the second-to-last axis, so an expert stack's per
    expert), N(0, 0.02) embeddings, zero norms, biases and cross-attention
    gates (so a gated layer starts as the identity), and the SSM
    blocks' own draws (``ssm.init_leaf``) — the JAX package's init; the two
    frameworks' generators give other numbers."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name, shape):
        special = ssm_lib.init_leaf(name, shape, gen, device)
        if special is not None:
            return special.to(cfg.param_dtype)
        if len(shape) <= 1:
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        std = 0.02 if name == "embed" else (2.0 / shape[-2]) ** 0.5
        return (torch.randn(shape, generator=gen, device=device) * std).to(
            cfg.param_dtype)

    return map_params(make, param_shapes(cfg))


# leaves the layers read in fp32 whatever the compute dtype: the norms, the
# cross-attention gates, the MoE router, the SSM decay parameters
_FP32_LEAVES = ("final_norm", "enc_final_norm", "gate_attn", "gate_mlp",
                "router", "A_log", "lambda")


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """The parameters with every matrix and bias cast to the compute dtype
    once, the leaves the layers read in fp32 (norms, the gates, the MoE
    router, the SSM decays) left as they are.  The layers cast each weight
    to the compute dtype where they use it, so this changes no number: it
    only keeps a decode step from re-casting billions of weights every
    token."""
    def cast(name, t):
        if name.startswith("ln") or name in _FP32_LEAVES:
            return t
        return t.to(cfg.compute_dtype)

    return map_params(cast, params)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count, the JAX package's formula (which counts a
    cross-attention block as a self-attention one and leaves out the norms
    and the gates)."""
    d, h, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = d * h * hd + 2 * d * hk * hd + h * hd * d
    if cfg.qkv_bias:
        attn += h * hd + 2 * hk * hd
    mats = 3 if cfg.gated_mlp else 2
    if cfg.n_experts > 0:
        mlp = cfg.n_experts * mats * d * f + d * cfg.n_experts
    else:
        mlp = mats * d * f
    ma = cfg.mamba_args()
    mamba = (d * 2 * ma.d_inner + ma.d_inner * d + ma.d_inner * ma.d_conv
             + ma.d_inner * (ma.dt_rank + 2 * ma.d_state)
             + ma.dt_rank * ma.d_inner + ma.d_inner * ma.d_state + ma.d_inner)
    ra = cfg.rglru_args()
    rec = (d * 2 * ra.d_inner + ra.d_inner * d + 2 * ra.d_inner * ra.d_inner
           + 2 * ra.d_inner + ra.d_inner * ra.d_conv)
    per_type = {"attn": attn + mlp, "xattn": attn + mlp, "rec": rec + mlp,
                "mamba": mamba}
    total = sum(per_type[t] for t in cfg.layer_types())
    total += cfg.vocab * d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    if cfg.encoder_decoder:
        total += (cfg.enc_layers or cfg.n_layers) * (attn + mlp)
        total += cfg.n_layers * attn          # decoder cross-attention
    return total


def count_active_params(cfg: ModelConfig) -> int:
    """MoE: only top_k experts per token count toward 6·N·D (the JAX
    package's formula, which discounts the experts of attention and
    cross-attention layers)."""
    if cfg.n_experts == 0:
        return count_params(cfg)
    mats = 3 if cfg.gated_mlp else 2
    inactive = (cfg.n_experts - cfg.moe_top_k) * mats * cfg.d_model * cfg.d_ff
    n_attn = sum(t in ("attn", "xattn") for t in cfg.layer_types())
    return count_params(cfg) - n_attn * inactive


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _project_qkv(p: Params, h_in: torch.Tensor, cfg: ModelConfig,
                 kv_src: Optional[torch.Tensor] = None):
    """q from ``h_in`` (B, S, D), k and v from ``kv_src`` (B, T, D) (the
    cross-attention features; ``h_in`` itself by default), each split into
    heads: (B, H, S, hd) and (B, HK, T, hd)."""
    cd = cfg.compute_dtype
    src = h_in if kv_src is None else kv_src
    q = h_in @ p["wq"].to(cd)
    k = src @ p["wk"].to(cd)
    v = src @ p["wv"].to(cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return (_split_heads(q, cfg.n_heads, cfg.hd),
            _split_heads(k, cfg.n_kv_heads, cfg.hd),
            _split_heads(v, cfg.n_kv_heads, cfg.hd))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) -> (B, n, S, hd)."""
    x = whole_if_uneven(x, 2, n)
    return x.reshape(x.shape[0], x.shape[1], n, hd).transpose(1, 2)


def _merge_heads(out: torch.Tensor, p: Params, cfg: ModelConfig):
    b, h, s, hd = out.shape
    out = whole_if_uneven(out.transpose(1, 2).reshape(b, s, h * hd), 2, h)
    return out @ p["wo"].to(cfg.compute_dtype)


def _mlp_core(m: Params, h_in: torch.Tensor, cfg: ModelConfig):
    """The dense MLP on normed input: SwiGLU, or GELU (tanh form, the JAX
    package's ``jax.nn.gelu``) between two matrices."""
    cd = cfg.compute_dtype
    if cfg.gated_mlp:
        return swiglu(h_in, m["w_gate"], m["w_up"], m["w_down"], cd)
    return gelu_mlp(h_in, m["w_up"], None, m["w_down"], None, cd)


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h_in = _norm_in(x, p["ln2"], cfg)
    if cfg.n_experts > 0:
        return _residual(x, moe_lib.moe_apply(
            p["mlp"], h_in, cfg.moe_args(), cfg.compute_dtype,
            cfg.act_sharding[0] if cfg.act_sharding else None))
    return _residual(x, _mlp_core(p["mlp"], h_in, cfg))


def _cross_attention(p: Params, x: torch.Tensor,
                     cross: Optional[torch.Tensor], cfg: ModelConfig):
    """The ``xattn`` branch: queries from ``x`` normed by ``lnx`` (an
    encoder-decoder's decoder layer) or ``ln1`` (a vision layer), keys and
    values from the features ``cross``, every position attended (no
    mask).  A single query takes ``dot``, as in the JAX package; a longer
    one ``cfg.attention_impl``, so ``hopper`` launches the flash kernel with
    ``causal=False`` and S != T.  ``cross`` None attends over ``x``
    itself, as the JAX package's does."""
    h_in = _norm_in(x, p["lnx" if "lnx" in p else "ln1"], cfg)
    q, k, v = _project_qkv(p["xattn"], h_in, cfg,
                           kv_src=None if cross is None else unshard(cross, 1))
    out = attn_lib.attend(_seq_split(q, cfg), k, v,
                          impl="dot" if x.shape[1] == 1 else
                          cfg.attention_impl, causal=False,
                          kv_chunk=cfg.attn_chunk)
    return _merge_heads(unshard(out, 2), p["xattn"], cfg)


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.float()).to(x.dtype)


def _xattn_block(p: Params, x: torch.Tensor, cross: Optional[torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """A vision layer: gated cross-attention, then a gated MLP, each
    residual scaled by the tanh of its gate."""
    x = _residual(x, _gate(p["gate_attn"], x)
                  * _cross_attention(p, x, cross, cfg))
    h_in = _norm_in(x, p["ln2"], cfg)
    return _residual(x, _gate(p["gate_mlp"], x)
                     * _mlp_core(p["mlp"], h_in, cfg))


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    head = _gathered(head, cfg)
    norm = _gathered(params["final_norm"], cfg)
    if isinstance(head, DTensor) and not is_split(head, 1):
        # no mesh dim splits the vocab: the rows keep the activations'
        # sequence split, else every device of its axis would repeat the
        # whole head's product
        x = rmsnorm(x, norm, cfg.norm_eps)
        return x @ unshard(head, 0).to(cfg.compute_dtype)
    x = _norm_in(x, norm, cfg)
    return unshard(x @ head.to(cfg.compute_dtype), 1)   # see _residual


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    # F.embedding, not advanced indexing: its backward on a card sums each
    # row's gradients in a fixed order (index_put_'s atomics do not), so a
    # training step is bitwise repeatable
    return F.embedding(tokens.long(), _gathered(params["embed"], cfg)).to(
        cfg.compute_dtype)


def _recurrent(cfg: ModelConfig, btype: str):
    """(full-sequence fn, step fn, args) of a recurrent layer type."""
    if btype == "rec":
        return ssm_lib.rglru_apply, ssm_lib.rglru_step, cfg.rglru_args()
    return ssm_lib.mamba_apply, ssm_lib.mamba_step, cfg.mamba_args()


def _recurrent_out(p: Params, x: torch.Tensor, y: torch.Tensor, btype: str,
                   cfg: ModelConfig) -> torch.Tensor:
    """The residual around a recurrent branch; a ``rec`` layer adds its MLP,
    a mamba block carries its own expansion."""
    x = _residual(x, y)
    return _mlp(p, x, cfg) if btype == "rec" else x


# ---------------------------------------------------------------------------
# Full-sequence forward (training shape, prefill)
# ---------------------------------------------------------------------------
def _remat(params: Params, cfg: ModelConfig, emit_cache: bool) -> bool:
    return (cfg.remat and not emit_cache and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(params)))


def _run_layers(stack: List[Params], x: torch.Tensor, cfg: ModelConfig,
                cross: Optional[torch.Tensor], causal: bool, emit_cache: bool,
                remat: bool):
    """Every layer of one stack in order: (x, one cache entry per layer)."""
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for btype, p in zip(cfg.layer_types(), stack):
        p = _gathered(p, cfg)
        if remat:
            x = checkpoint(_layer, btype, p, x, positions, cfg, False, cross,
                           causal, use_reentrant=False)[0]
        else:
            x, entry = _layer(btype, p, x, positions, cfg, emit_cache, cross,
                              causal)
            caches.append(entry)
        x = _constrain_act(x, cfg)
    return x, caches


def encode(params: Params, cfg: ModelConfig,
           enc_inputs: torch.Tensor) -> torch.Tensor:
    """The encoder over precomputed front-end embeddings (B, T, D): its
    self-attention runs unmasked (``causal=False``; ``hopper`` launches the
    flash kernel so), then ``enc_final_norm``.  Returns (B, T, D) in the
    compute dtype, the features the decoder's cross-attention reads."""
    x = _constrain_act(enc_inputs.to(cfg.compute_dtype), cfg)
    x, _ = _run_layers(params["encoder"], x, encoder_config(cfg), None,
                       False, False, _remat(params, cfg, False))
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _cross_features(params: Params, cfg: ModelConfig, enc_inputs,
                    img_embeds) -> Optional[torch.Tensor]:
    if cfg.encoder_decoder:
        if enc_inputs is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"encoder inputs (enc_inputs)")
        return encode(params, cfg, enc_inputs)
    if cfg.frontend == "vision":
        if img_embeds is None:
            raise ValueError(f"{cfg.name}: a vision model needs image "
                             f"embeddings (img_embeds)")
        return img_embeds.to(cfg.compute_dtype)
    return None


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            enc_inputs: Optional[torch.Tensor] = None,
            img_embeds: Optional[torch.Tensor] = None,
            emit_cache: bool = False):
    """tokens (B, S) int -> (logits (B, S, V), cache or None).

    An encoder-decoder config needs ``enc_inputs`` (B, T, D), the front
    end's frame embeddings, which :func:`encode` turns into the features
    every decoder layer's cross-attention reads; a vision config needs
    ``img_embeds`` (B, T, D), which its gated layers read as they are.
    With ``emit_cache`` (prefill) the cache holds one entry per layer,
    ``pos`` S and, for a cross-attention config, ``cross`` (those
    features): an attention layer's K/V in the compute dtype (with an
    ``attn_window`` shorter than S, only the last ``attn_window`` positions,
    position p in slot p % attn_window, as the JAX package keeps them), a
    recurrent layer's decode state, ``{}`` for a gated cross-attention
    layer.  Attention runs through ``cfg.attention_impl``; ``hopper``
    launches the flash-attention kernel once per self-attention and per
    cross-attention on a CUDA tensor (and once per encoder layer).  A
    recurrent config needs S to be a multiple of ``min(scan_chunk, S)``."""
    cross = _cross_features(params, cfg, enc_inputs, img_embeds)
    x = _constrain_act(_embed(params, tokens, cfg), cfg)
    x, caches = _run_layers(params["layers"], x, cfg, cross, True,
                            emit_cache, _remat(params, cfg, emit_cache))
    logits = _logits(params, x, cfg)
    if not emit_cache:
        return logits, None
    cache = {"layers": caches,
             "pos": torch.tensor(tokens.shape[1], dtype=torch.int32)}
    if cross is not None:
        cache["cross"] = cross
    return logits, cache


def _layer(btype: str, p: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, emit_cache: bool,
           cross: Optional[torch.Tensor] = None, causal: bool = True):
    """One layer of the full-sequence forward: (x, its cache entry or
    None)."""
    if btype in RECURRENT:
        apply, _, args = _recurrent(cfg, btype)
        h_in = _norm_in(x, p["ln1"], cfg)
        y = apply(p[btype], h_in, args, cfg.compute_dtype,
                  return_state=emit_cache)
        entry = None
        if emit_cache:
            y, state = y
            entry = {btype: state}
        return _recurrent_out(p, x, y, btype, cfg), entry
    if btype == "xattn":
        return _xattn_block(p, x, cross, cfg), {} if emit_cache else None
    h_in = _norm_in(x, p["ln1"], cfg)
    q, k, v = _project_qkv(p["attn"], h_in, cfg)
    q = apply_rope(q, positions[None, None], cfg.rope_theta)
    k = apply_rope(k, positions[None, None], cfg.rope_theta)
    out = attn_lib.attend(_seq_split(q, cfg), k, v, impl=cfg.attention_impl,
                          causal=causal, window=cfg.attn_window,
                          kv_chunk=cfg.attn_chunk)
    x = _finish_block(p, x, unshard(out, 2), cfg, cross)
    if not emit_cache:
        return x, None
    w = cfg.attn_window
    if w is not None and k.shape[2] > w:
        # rolling buffer of the last w positions, position p in slot p % w:
        # the layout a windowed decode step writes and reads
        t = k.shape[2]
        idx = torch.arange(w, device=k.device) + (t // w) * w
        idx = torch.where(idx < t, idx, idx - w)
        k, v = k[:, :, idx], v[:, :, idx]
    return x, {"k": k.to(cfg.compute_dtype), "v": v.to(cfg.compute_dtype)}


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` (``tokens``, ``labels``, optional
    ``mask``, and ``enc_inputs`` or ``img_embeds`` for a cross-attention
    config), fp32.  Differentiable in every parameter leaf: the layers cast
    each weight where they use it, so gradients reach the fp32 masters."""
    logits, _ = forward(params, cfg, batch["tokens"],
                        enc_inputs=batch.get("enc_inputs"),
                        img_embeds=batch.get("img_embeds"))
    return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


def decay_mask(cfg: ModelConfig) -> Params:
    """Which parameter leaves AdamW decays, as the JAX package decays them:
    a leaf of ndim >= 2 in ITS layout, where the layers of whole pattern
    units (and every encoder layer) are stacked on a leading axis, so a
    stacked layer's leaf of ndim >= 1 (norms and biases included, not the
    scalar gates) decays, and the remainder layers, the embeddings and the
    final norms keep the rule as they are."""
    shapes = param_shapes(cfg)

    def stacked_layers(stack, n_stacked):
        # a stacked layer's leaf has one more axis there
        return [map_params(lambda _, shape, i=i: len(shape) + (
            i < n_stacked) >= 2, layer) for i, layer in enumerate(stack)]

    tree = map_params(lambda _, shape: len(shape) >= 2, shapes)
    tree["layers"] = stacked_layers(
        shapes["layers"], cfg.n_super * len(cfg.pattern_unit()))
    if cfg.encoder_decoder:
        tree["encoder"] = stacked_layers(shapes["encoder"],
                                         len(shapes["encoder"]))
    return tree


# ---------------------------------------------------------------------------
# Decode: one token per sequence against a cache
# ---------------------------------------------------------------------------
def _state_entry(cfg: ModelConfig, btype: str, batch: int, device):
    """A recurrent layer's zero decode state for ``batch`` rows."""
    if btype == "rec":
        return {"rec": ssm_lib.rglru_init_state(cfg.rglru_args(), batch,
                                                device=device)}
    return {"mamba": ssm_lib.mamba_init_state(cfg.mamba_args(), batch,
                                              device=device)}


def _layer_entries(cfg: ModelConfig, batch: int, kv_shape: tuple,
                   device) -> List[Dict[str, Any]]:
    """One cache entry per layer: zero K/V of ``kv_shape`` (rows or an
    arena) for an attention layer, a zero state of ``batch`` rows for a
    recurrent one, nothing for a gated cross-attention layer (it reads the
    cache's ``cross``)."""
    def entry(btype):
        if btype in RECURRENT:
            return _state_entry(cfg, btype, batch, device)
        if btype == "xattn":
            return {}
        return {name: torch.zeros(kv_shape, dtype=cfg.compute_dtype,
                                  device=device) for name in ("k", "v")}

    return [entry(t) for t in cfg.layer_types()]


def _with_cross(cache: Dict[str, Any], cfg: ModelConfig, batch: int,
                max_seq: int, device) -> Dict[str, Any]:
    """Add the zero cross-attention rows of a cross-attention config:
    (batch, max_seq, D) for an encoder-decoder, (batch, img_seq, D) for a
    vision config, in the compute dtype (the JAX package's shapes).  The
    caller writes each row's features (``encode``'s output, or the image
    embeddings) in place."""
    if cfg.encoder_decoder or cfg.frontend == "vision":
        t = max_seq if cfg.encoder_decoder else cfg.img_seq
        cache["cross"] = torch.zeros((batch, t, cfg.d_model),
                                     dtype=cfg.compute_dtype, device=device)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict[str, Any]:
    """Dense decode cache: each attention layer's K and V as ``(batch,
    n_kv_heads, t, head_dim)`` in the compute dtype, ``t = min(attn_window,
    max_seq)`` (a rolling buffer, position p in slot p % t, for a windowed
    config), each recurrent layer's state, one position ``pos`` shared
    by the batch, and a cross-attention config's zero ``cross`` rows."""
    t = min(cfg.attn_window or max_seq, max_seq)
    cache = {"layers": _layer_entries(cfg, batch,
                                      (batch, cfg.n_kv_heads, t, cfg.hd),
                                      device),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    return _with_cross(cache, cfg, batch, max_seq, device)


def init_slot_cache(cfg: ModelConfig, n_slots: int, max_seq: int, *,
                    device="cuda") -> Dict[str, Any]:
    """Dense cache for the continuous-batching engine: each batch row is a
    slot owned by at most one request, with its own position, so ``pos`` is
    (n_slots,).  Otherwise :func:`init_cache`'s layout."""
    cache = init_cache(cfg, n_slots, max_seq, device=device)
    cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return cache


def reset_slot_state(cfg: ModelConfig, cache: Dict[str, Any],
                     slot: int) -> Dict[str, Any]:
    """Clear one slot's per-request state before binding a new request, in
    either slot layout: its position and its recurrent states, which carry
    no position and would leak across tenants (zeroed, as ``init_cache``
    makes them).  KV rows and pages need no clearing (position masks hide
    stale entries), the paged block tables survive, and so does the slot's
    cross row (the JAX package's rule: its owner writes it).  In place, so
    a captured step's buffers stay the same storage; returns the cache."""
    for layer in cache["layers"]:
        for btype in RECURRENT:
            for t in layer.get(btype, {}).values():
                t[slot].zero_()
    cache["pos"][slot] = 0
    return cache


def _qkv_at(p: Params, x: torch.Tensor, cfg: ModelConfig,
            pos: torch.Tensor):
    """The block's projections, rotated to ``pos``: (B,) per-slot positions
    or one scalar position for the whole batch."""
    h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h_in, cfg)
    posq = pos.reshape(-1, 1, 1)
    return (apply_rope(q, posq, cfg.rope_theta),
            apply_rope(k, posq, cfg.rope_theta), v)


def _finish_block(p: Params, x: torch.Tensor, out: torch.Tensor,
                  cfg: ModelConfig,
                  cross: Optional[torch.Tensor]) -> torch.Tensor:
    """An attention block after its attention: the output projection, an
    encoder-decoder's cross-attention branch, the MLP, each a residual."""
    x = _residual(x, _merge_heads(out, p["attn"], cfg))
    if "xattn" in p and cross is not None:
        x = _residual(x, _cross_attention(p, x, cross, cfg))
    return _mlp(p, x, cfg)


def _dense_attn_block(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                      cfg: ModelConfig, pos: torch.Tensor,
                      active: Optional[torch.Tensor],
                      cross: Optional[torch.Tensor]) -> torch.Tensor:
    q, k, v = _qkv_at(p, x, cfg, pos)
    b, t = x.shape[0], layer["k"].shape[2]
    if cfg.attn_window is not None:
        slot = pos % t                       # rolling buffer
    else:
        slot = torch.clamp(pos, max=t - 1)
    rows = torch.arange(b, device=x.device)
    slot = slot.long().expand(b)
    for name, new in (("k", k), ("v", v)):
        cache_rows = layer[name]
        new = new[:, :, 0].to(cache_rows.dtype)           # (B, HK, D)
        if isinstance(cache_rows, DTensor):
            # a row write into a cache sharded on batch and time has no
            # in-place DTensor strategy: select the row by a mask, out of
            # place, and replace the entry, on the cache's placements
            hit = torch.arange(t, device=x.device)[None] == slot[:, None]
            if active is not None:
                hit = hit & active[:, None]
            layer[name] = torch.where(
                hit[:, None, :, None], new[:, :, None], cache_rows
            ).redistribute(cache_rows.device_mesh, cache_rows.placements)
            continue
        if active is not None:               # inactive slots keep their row
            new = torch.where(active[:, None, None], new,
                              cache_rows[rows, :, slot])
        cache_rows[rows, :, slot] = new
    out = attn_lib.decode_attention(q, layer["k"], layer["v"], pos=pos,
                                    window=cfg.attn_window)
    return _finish_block(p, x, out, cfg, cross)


def _recurrent_block(btype: str, p: Params, x: torch.Tensor,
                     layer: Dict[str, Any], cfg: ModelConfig,
                     active: Optional[torch.Tensor]) -> torch.Tensor:
    """One token of a recurrent layer.  The slot-major state is written in
    place; an inactive slot keeps its state bit for bit."""
    _, step, args = _recurrent(cfg, btype)
    state = layer[btype]
    h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, new = step(p[btype], h_in, state, args, cfg.compute_dtype)
    for name, t in list(state.items()):
        upd = new[name]
        if active is not None:
            upd = torch.where(active.reshape((-1,) + (1,) * (t.dim() - 1)),
                              upd, t)
        if isinstance(t, DTensor):
            # an in-place copy needs the placements to match: the new
            # state replaces the entry
            state[name] = upd
        else:
            t.copy_(upd)
    return _recurrent_out(p, x, y, btype, cfg)


def _decode_layers(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                   tokens: torch.Tensor, active: Optional[torch.Tensor],
                   attn_block) -> torch.Tensor:
    """Embed, every layer in order (``attn_block(p, x, layer, cross)`` for
    an attention layer, the shared recurrent and gated cross-attention
    steps otherwise), the head: the one body the dense, paged and static
    steps share.  ``cross`` is the cache's cross rows, or None."""
    cross = cache.get("cross")
    x = _constrain_act(_embed(params, tokens, cfg), cfg)
    for btype, p, layer in zip(cfg.layer_types(), params["layers"],
                               cache["layers"]):
        p = _gathered(p, cfg)
        if btype in RECURRENT:
            x = _recurrent_block(btype, p, x, layer, cfg, active)
        elif btype == "xattn":
            x = _xattn_block(p, x, cross, cfg)
        else:
            x = attn_block(p, x, layer, cross)
        x = _constrain_act(x, cfg)
    return _logits(params, x, cfg)


def _decode_step_impl(params: Params, cfg: ModelConfig,
                      cache: Dict[str, Any], tokens: torch.Tensor,
                      active: Optional[torch.Tensor]):
    pos = cache["pos"]
    logits = _decode_layers(
        params, cfg, cache, tokens, active,
        lambda p, x, layer, cross: _dense_attn_block(p, x, layer, cfg, pos,
                                                     active, cross))
    pos.copy_(pos + 1 if active is None else torch.where(active, pos + 1,
                                                         pos))
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor):
    """One decode step of the whole batch at the cache's one position (the
    static server).  tokens (B, 1) -> (logits (B, 1, V), cache), the cache
    updated in place."""
    return _decode_step_impl(params, cfg, cache, tokens, None)


def decode_step_slots(params: Params, cfg: ModelConfig,
                      cache: Dict[str, Any], tokens: torch.Tensor,
                      active: torch.Tensor):
    """One engine step over independent slots on the dense slot cache.

    tokens (B, 1) int: each slot's next token; active (B,) bool;
    ``cache["pos"]`` (B,) int32.  Each active slot's K/V is written at its
    position, its recurrent states advance, and its position advances; an
    inactive slot keeps its rows, states and position.  Cross-attention
    reads each slot's ``cache["cross"]`` row.  The per-slot math is
    :func:`decode_step`'s, which makes continuous batching's tokens those of
    the static server.  Returns (logits (B, 1, V), cache), the cache updated
    in place.
    """
    return _decode_step_impl(params, cfg, cache, tokens, active)


# ---------------------------------------------------------------------------
# Block-paged slot decode (serving)
# ---------------------------------------------------------------------------
def init_slot_cache_paged(cfg: ModelConfig, n_slots: int, max_seq: int, *,
                          block_size: int = 16,
                          total_blocks: Optional[int] = None,
                          device="cuda") -> Dict[str, Any]:
    """Block-paged cache for the continuous-batching engine.

    Each attention layer keeps K and V in one ``(total_blocks + 1,
    n_kv_heads, block_size, head_dim)`` arena each, in the compute dtype; a
    slot's sequence lives in the pages its ``block_tables`` row names (page
    ``j`` holds positions ``[j * block_size, (j + 1) * block_size)``).  The
    last page is the trash page: inactive slots write there, and no table
    names it.  One table row serves every layer.  Recurrent states and
    cross-attention rows stay slot-major, as in the dense layout (they are
    O(1) in the sequence's length).  Sliding-window configs must serve on
    the dense layout.
    """
    if cfg.attn_window is not None:
        raise ValueError(
            "paged KV layout does not support sliding-window attention "
            "(rolling-buffer slots); serve this config with the dense "
            "layout")
    blocks_per_slot = -(-max_seq // block_size)
    if total_blocks is None:
        total_blocks = n_slots * blocks_per_slot
    shape = (total_blocks + 1, cfg.n_kv_heads, block_size, cfg.hd)
    cache = {"layers": _layer_entries(cfg, n_slots, shape, device),
             "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
             "block_tables": torch.zeros((n_slots, blocks_per_slot),
                                         dtype=torch.int32, device=device)}
    return _with_cross(cache, cfg, n_slots, max_seq, device)


def _paged_attn_block(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                      cfg: ModelConfig, pos: torch.Tensor,
                      block_tables: torch.Tensor, active: torch.Tensor,
                      max_seq: int,
                      cross: Optional[torch.Tensor]) -> torch.Tensor:
    q, k, v = _qkv_at(p, x, cfg, pos)
    k_arena, v_arena = layer["k"], layer["v"]
    b = x.shape[0]
    bs = k_arena.shape[-2]
    nb = block_tables.shape[1]
    trash = k_arena.shape[0] - 1
    j = torch.clamp(pos.long() // bs, 0, nb - 1)
    off = (pos.long() % bs)[:, None]
    phys = block_tables[torch.arange(b, device=x.device), j].long()
    phys = torch.where(active, phys, trash)[:, None]
    heads = torch.arange(cfg.n_kv_heads, device=x.device)[None, :]
    k_arena[phys, heads, off] = k[:, :, 0, :].to(k_arena.dtype)
    v_arena[phys, heads, off] = v[:, :, 0, :].to(v_arena.dtype)

    out = attn_lib.paged_decode_attention(
        q, k_arena, v_arena, block_tables, pos, max_seq=max_seq,
        impl=cfg.paged_attention_impl)
    return _finish_block(p, x, out, cfg, cross)


def decode_step_slots_paged(params: Params, cfg: ModelConfig,
                            cache: Dict[str, Any], tokens: torch.Tensor,
                            active: torch.Tensor, *, max_seq: int):
    """One engine step over independent slots on the block-paged cache.

    tokens (B, 1) int: each slot's next token; active (B,) bool;
    ``cache["pos"]`` (B,) int32 per-slot positions and
    ``cache["block_tables"]`` (B, NB) int32.  Each active slot's new K/V is
    written into its page at ``pos``, its recurrent states advance and its
    position advances by one; an inactive slot writes to the trash page and
    keeps its position, states and live pages.  Everything but the
    attention block is :func:`decode_step_slots`'s.  Returns (logits (B, 1,
    V), cache), the cache updated in place (``pos`` too: a CUDA graph of the
    step reads the same buffer).
    """
    pos = cache["pos"]
    block_tables = cache["block_tables"]
    logits = _decode_layers(
        params, cfg, cache, tokens, active,
        lambda p, x, layer, cross: _paged_attn_block(
            p, x, layer, cfg, pos, block_tables, active, max_seq, cross))
    pos.copy_(torch.where(active, pos + 1, pos))
    return logits, cache


def _multi_attn_block_paged(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                            cfg: ModelConfig, pos: torch.Tensor,
                            block_tables: torch.Tensor, active: torch.Tensor,
                            max_seq: int,
                            cross: Optional[torch.Tensor]) -> torch.Tensor:
    """Window counterpart of :func:`_paged_attn_block`: x is (B, M, d), M
    consecutive tokens per slot at positions pos..pos+M-1, whose K/V goes
    into the slot's pages in one ``index_put_``; each query attends over
    cache slots <= its own position (the freshly written window prefix
    included, as M sequential single-token steps see it)."""
    h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h_in, cfg)             # (B,H,M,hd)
    m = x.shape[1]
    wpos = pos[:, None] + torch.arange(m, dtype=pos.dtype,
                                       device=x.device)      # (B, M)
    posq = wpos[:, None, :]
    q = apply_rope(q, posq, cfg.rope_theta)
    k = apply_rope(k, posq, cfg.rope_theta)

    k_arena, v_arena = layer["k"], layer["v"]
    bs = k_arena.shape[-2]
    nb = block_tables.shape[1]
    trash = k_arena.shape[0] - 1
    j = torch.clamp(wpos.long() // bs, 0, nb - 1)
    off = (wpos.long() % bs)[:, :, None]
    phys = torch.gather(block_tables, 1, j).long()
    phys = torch.where(active[:, None], phys, trash)[:, :, None]
    heads = torch.arange(cfg.n_kv_heads, device=x.device)[None, None, :]
    # an active slot's window positions are distinct and slots own disjoint
    # pages, so its writes never collide.  Inactive slots all write to the
    # trash page, where their indices collide; index_put_ keeps an arbitrary
    # one of colliding writes, which is harmless because the trash page is
    # never attended
    k_arena.index_put_((phys, heads, off),
                       k.transpose(1, 2).to(k_arena.dtype))
    v_arena.index_put_((phys, heads, off),
                       v.transpose(1, 2).to(v_arena.dtype))

    out = attn_lib.paged_decode_attention_multi(
        q, k_arena, v_arena, block_tables, pos, max_seq=max_seq)
    return _finish_block(p, x, out, cfg, cross)


def decode_multi_step_slots_paged(params: Params, cfg: ModelConfig,
                                  cache: Dict[str, Any], tokens: torch.Tensor,
                                  active: torch.Tensor, *, max_seq: int,
                                  advance: bool = True,
                                  stepwise: bool = True):
    """M-token engine step over independent slots on the block-paged cache.

    tokens (B, M) int: M *consecutive* chain tokens per slot starting at
    ``cache["pos"]``, against the cache contract of
    :func:`decode_step_slots_paged`.  Returns (logits (B, M, V), cache):
    logits[:, i] conditions on tokens[:, :i+1], so feeding the committed
    head plus k drafted tokens gives the target's greedy continuation at
    every window offset in ONE call (speculative verification), and feeding
    a prompt chunk replays prefill M tokens at a time (the draft's
    catch-up).

    ``stepwise`` (the verify) is M calls of :func:`decode_step_slots_paged`,
    so each offset's logits are a plain step's bit for bit whatever the GEMM
    library does with more rows (on an H100 cuBLAS rounds qwen2's 8960 x
    1536 down projection otherwise from 89 rows: ``chip_smoke.py`` phase 7
    gates 32 slots x 5 tokens), and its attention is the step's
    (``cfg.paged_attention_impl``: the paged kernel under ``hopper``).  The
    price: the verify reads every weight M times.  False runs the window as
    one multi-token step on the gather path: the draft's catch-up, whose
    numbers only steer proposals; step by step, its prompt-long windows cut
    forced speculation's tok/s ~6x on an H100 (``chip_smoke.py`` phase 10).

    ``advance`` True moves each active slot's position by M; False leaves
    ``pos`` alone so the caller commits only the accepted prefix.
    Positions pos+c..pos+M-1 then hold *stale* K/V from the rejected tail,
    which is safe: every later feed starts at the committed position and
    rewrites forward before attention reaches them (attention masks
    kv_slot <= query position).

    Everything is in place, as in :func:`decode_step_slots_paged`: the
    arenas through ``index_put_``, ``pos`` through ``copy_``, so a CUDA graph
    of a step that calls this reads and writes the cache's own buffers.
    Requires an all-attention config (an encoder-decoder's decoder is one;
    a gated cross-attention layer is not).
    """
    if any(t != "attn" for t in cfg.layer_types()):
        raise ValueError(
            "multi-token slot step requires an all-attention config: "
            "recurrent/SSM layer state has no multi-token slot step")
    pos = cache["pos"]
    if stepwise:
        pos0 = pos.clone()
        logits = torch.cat([
            decode_step_slots_paged(params, cfg, cache, tokens[:, i:i + 1],
                                    active, max_seq=max_seq)[0]
            for i in range(tokens.shape[1])], dim=1)
        if not advance:
            pos.copy_(pos0)
        return logits, cache
    block_tables = cache["block_tables"]
    cross = cache.get("cross")
    x = _embed(params, tokens, cfg)
    for p, layer in zip(params["layers"], cache["layers"]):
        x = _multi_attn_block_paged(p, x, layer, cfg, pos, block_tables,
                                    active, max_seq, cross)
    logits = _logits(params, x, cfg)
    if advance:
        pos.copy_(torch.where(active, pos + tokens.shape[1], pos))
    return logits, cache
