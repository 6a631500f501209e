"""The config-driven transformer family, decoder-only: dense llama-style
decoders (qwen2, deepseek-coder, granite, minicpm), the MoE decoders
(mixtral, phi3.5-moe; ``models/moe.py``), the Mamba-1 decoder (falcon-mamba;
``models/ssm.py``) and the RG-LRU hybrid (recurrentgemma).  Full-sequence
forward (training shape and prefill), the decode step over a dense cache
(the static server's; a rolling buffer for windowed configs), the slot
decode steps the serving engine runs, on the dense slot cache and on the
block-paged one, and the block-paged M-token step that speculative decoding
verifies with.  Training reads ``loss_fn`` (differentiable in every leaf,
each layer recomputed in the backward under ``remat``) and ``decay_mask``
(the leaves AdamW decays).

Plain functions on explicit parameters, as in the JAX package: ``params`` is
a dict holding ``embed`` (V, D), ``final_norm`` (D,), ``layers`` — one dict
per layer, by the layer's type: ``attn`` layers hold ``ln1``, ``attn``
(``wq wk wv wo`` [+ ``bq bk bv``]), ``ln2`` and ``mlp`` (``w_gate w_up
w_down``, or the MoE's ``router`` and expert stacks); ``rec`` layers hold
``ln1``, ``rec`` (the RG-LRU branch), ``ln2`` and ``mlp``; ``mamba`` layers
hold ``ln1`` and ``mamba`` — and ``lm_head`` when embeddings are untied.
The JAX package stacks layers for ``lax.scan``;
``models.convert.params_from_numpy`` unstacks its tree into this layout.

A cache holds one entry per layer: ``{"k", "v"}`` rows (dense) or arenas
(paged) for an attention layer, ``{"rec": {"h", "conv"}}`` or ``{"mamba":
{"h", "conv"}}`` for a recurrent one, slot-major in either layout.  Unlike
the JAX package's pure functions, the decode steps update the cache in place
(the KV rows or arenas, the recurrent states, the positions): it is the
serving engine's state, copying a 28-layer cache every token would double
the step's traffic, and a CUDA graph replaying the step reads and writes the
same buffers.

Cross-attention, the encoder-decoder and the vision front end are not
ported yet: configs that need them are refused (ROADMAP §1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..tree import tree_leaves
from . import attention as attn_lib
from . import layers
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import apply_rope, rmsnorm, softmax_cross_entropy, swiglu

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
    # encoder-decoder and front end (refused: not ported yet)
    encoder_decoder: bool = False
    frontend: str = "none"                  # none | audio | vision
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
    grad_accum: int = 1

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


def _check_decoder_only(cfg: ModelConfig) -> None:
    """Refuse what the port does not run yet: cross-attention layers, the
    encoder-decoder and the vision front end."""
    if (cfg.encoder_decoder or cfg.frontend != "none"
            or "xattn" in cfg.layer_types()):
        raise NotImplementedError(
            f"{cfg.name}: cross-attention, the encoder-decoder and the "
            f"vision front end are not ported yet (ROADMAP §1 item 7); the "
            f"port runs decoder-only configs of layer types attn, rec and "
            f"mamba")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _block_shapes(cfg: ModelConfig, btype: str) -> Params:
    d, h, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    if cfg.n_experts > 0:
        mlp = moe_lib.moe_param_shapes(cfg.moe_args())
    else:
        mlp = {"w_up": (d, f), "w_down": (f, d)}
        if cfg.gated_mlp:
            mlp["w_gate"] = (d, f)
    if btype == "attn":
        attn = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
                "wo": (h * hd, d)}
        if cfg.qkv_bias:
            attn.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
        return {"ln1": (d,), "attn": attn, "ln2": (d,), "mlp": mlp}
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
    _check_decoder_only(cfg)
    d = cfg.d_model
    shapes: Params = {"embed": (cfg.vocab, d), "final_norm": (d,),
                      "layers": [_block_shapes(cfg, t)
                                 for t in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
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
    expert), N(0, 0.02) embeddings, zero norms and biases, and the SSM
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
        if len(shape) == 1:
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        std = 0.02 if name == "embed" else (2.0 / shape[-2]) ** 0.5
        return (torch.randn(shape, generator=gen, device=device) * std).to(
            cfg.param_dtype)

    return map_params(make, param_shapes(cfg))


# leaves the layers read in fp32 whatever the compute dtype: the norms, the
# MoE router, the SSM decay parameters
_FP32_LEAVES = ("final_norm", "router", "A_log", "lambda")


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """The parameters with every matrix and bias cast to the compute dtype
    once, the leaves the layers read in fp32 (norms, the MoE router, the
    SSM decays) left as they are.  The layers cast each weight to the
    compute dtype where they use it, so this changes no number: it only
    keeps a decode step from re-casting billions of weights every token."""
    def cast(name, t):
        if name.startswith("ln") or name in _FP32_LEAVES:
            return t
        return t.to(cfg.compute_dtype)

    return map_params(cast, params)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count, the JAX package's formula."""
    _check_decoder_only(cfg)
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
    per_type = {"attn": attn + mlp, "rec": rec + mlp, "mamba": mamba}
    total = sum(per_type[t] for t in cfg.layer_types())
    total += cfg.vocab * d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    return total


def count_active_params(cfg: ModelConfig) -> int:
    """MoE: only top_k experts per token count toward 6·N·D (the JAX
    package's formula, which discounts the experts of attention layers)."""
    if cfg.n_experts == 0:
        return count_params(cfg)
    mats = 3 if cfg.gated_mlp else 2
    inactive = (cfg.n_experts - cfg.moe_top_k) * mats * cfg.d_model * cfg.d_ff
    return count_params(cfg) - cfg.layer_types().count("attn") * inactive


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _project_qkv(p: Params, h_in: torch.Tensor, cfg: ModelConfig):
    cd = cfg.compute_dtype
    q = h_in @ p["wq"].to(cd)
    k = h_in @ p["wk"].to(cd)
    v = h_in @ p["wv"].to(cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    b, s = h_in.shape[0], h_in.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    return q, k, v


def _merge_heads(out: torch.Tensor, p: Params, cfg: ModelConfig):
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p["wo"].to(cfg.compute_dtype)


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
         norm=None) -> torch.Tensor:
    cd = cfg.compute_dtype
    m = p["mlp"]
    h_in = (norm or rmsnorm)(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts > 0:
        return x + moe_lib.moe_apply(m, h_in, cfg.moe_args(), cd)
    if cfg.gated_mlp:
        return x + swiglu(h_in, m["w_gate"], m["w_up"], m["w_down"], cd)
    h = F.gelu(h_in @ m["w_up"].to(cd), approximate="tanh")
    return x + h @ m["w_down"].to(cd)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig, norm=None):
    x = (norm or rmsnorm)(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head.to(cfg.compute_dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    # F.embedding, not advanced indexing: its backward on a card sums each
    # row's gradients in a fixed order (index_put_'s atomics do not), so a
    # training step is bitwise repeatable
    return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)


def _recurrent(cfg: ModelConfig, btype: str):
    """(full-sequence fn, step fn, args) of a recurrent layer type."""
    if btype == "rec":
        return ssm_lib.rglru_apply, ssm_lib.rglru_step, cfg.rglru_args()
    return ssm_lib.mamba_apply, ssm_lib.mamba_step, cfg.mamba_args()


def _recurrent_out(p: Params, x: torch.Tensor, y: torch.Tensor, btype: str,
                   cfg: ModelConfig) -> torch.Tensor:
    """The residual around a recurrent branch; a ``rec`` layer adds its MLP,
    a mamba block carries its own expansion."""
    x = x + y
    return _mlp(p, x, cfg) if btype == "rec" else x


# ---------------------------------------------------------------------------
# Full-sequence forward (training shape, prefill)
# ---------------------------------------------------------------------------
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            emit_cache: bool = False):
    """tokens (B, S) int -> (logits (B, S, V), cache or None).

    With ``emit_cache`` (prefill) the cache holds one entry per layer and
    ``pos`` S: an attention layer's K/V in the compute dtype (with an
    ``attn_window`` shorter than S, only the last ``attn_window`` positions,
    position p in slot p % attn_window, as the JAX package keeps them), a
    recurrent layer's decode state.  Attention runs through
    ``cfg.attention_impl``; ``hopper`` launches the flash-attention kernel
    once per attention layer on a CUDA tensor.  A recurrent config needs S
    to be a multiple of ``min(scan_chunk, S)``."""
    _check_decoder_only(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = (cfg.remat and not emit_cache and torch.is_grad_enabled()
             and any(t.requires_grad for t in tree_leaves(params)))
    caches = []
    for btype, p in zip(cfg.layer_types(), params["layers"]):
        if remat:
            x = checkpoint(_layer, btype, p, x, positions, cfg, False,
                           use_reentrant=False)[0]
            continue
        x, entry = _layer(btype, p, x, positions, cfg, emit_cache)
        caches.append(entry)
    logits = _logits(params, x, cfg)
    if not emit_cache:
        return logits, None
    return logits, {"layers": caches,
                    "pos": torch.tensor(tokens.shape[1], dtype=torch.int32)}


def _layer(btype: str, p: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, emit_cache: bool):
    """One layer of the full-sequence forward: (x, its cache entry or
    None)."""
    if btype in RECURRENT:
        apply, _, args = _recurrent(cfg, btype)
        h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
        y = apply(p[btype], h_in, args, cfg.compute_dtype,
                  return_state=emit_cache)
        entry = None
        if emit_cache:
            y, state = y
            entry = {btype: state}
        return _recurrent_out(p, x, y, btype, cfg), entry
    h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h_in, cfg)
    q = apply_rope(q, positions[None, None], cfg.rope_theta)
    k = apply_rope(k, positions[None, None], cfg.rope_theta)
    out = attn_lib.attend(q, k, v, impl=cfg.attention_impl, causal=True,
                          window=cfg.attn_window, kv_chunk=cfg.attn_chunk)
    x = x + _merge_heads(out, p["attn"], cfg)
    x = _mlp(p, x, cfg)
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
    ``mask``), fp32.  Differentiable in every parameter leaf: the layers
    cast each weight where they use it, so gradients reach the fp32
    masters."""
    logits, _ = forward(params, cfg, batch["tokens"])
    return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


def decay_mask(cfg: ModelConfig) -> Params:
    """Which parameter leaves AdamW decays, as the JAX package decays them:
    a leaf of ndim >= 2 in ITS layout, where the layers of whole pattern
    units are stacked on a leading axis (every leaf of theirs, norms and
    biases included, is then >= 2-D) and the remainder layers, the
    embeddings and the final norm are not."""
    stacked = cfg.n_super * len(cfg.pattern_unit())
    tree = map_params(lambda _, shape: len(shape) >= 2, param_shapes(cfg))
    tree["layers"] = [map_params(lambda *_: True, layer) if i < stacked
                      else layer for i, layer in enumerate(tree["layers"])]
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
    recurrent one."""
    def entry(btype):
        if btype in RECURRENT:
            return _state_entry(cfg, btype, batch, device)
        return {name: torch.zeros(kv_shape, dtype=cfg.compute_dtype,
                                  device=device) for name in ("k", "v")}

    return [entry(t) for t in cfg.layer_types()]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict[str, Any]:
    """Dense decode cache: each attention layer's K and V as ``(batch,
    n_kv_heads, t, head_dim)`` in the compute dtype, ``t = min(attn_window,
    max_seq)`` (a rolling buffer, position p in slot p % t, for a windowed
    config), each recurrent layer's state, and one position ``pos`` shared
    by the batch."""
    _check_decoder_only(cfg)
    t = min(cfg.attn_window or max_seq, max_seq)
    return {"layers": _layer_entries(cfg, batch,
                                     (batch, cfg.n_kv_heads, t, cfg.hd),
                                     device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


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
    stale entries), and the paged block tables survive.  In place, so a
    captured step's buffers stay the same storage; returns the cache."""
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
                  cfg: ModelConfig, norm=None) -> torch.Tensor:
    x = x + _merge_heads(out, p["attn"], cfg)
    return _mlp(p, x, cfg, norm)


def rmsnorm_multi(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of a window x (B, M, d), each offset normalized as the
    single-token step's contiguous (B, 1, d) tensor.  On a card the order
    in which a row's mean of squares is summed depends on how many rows
    one reduction holds, so a (B·M)-row norm can differ in the last bit
    from the step's B-row norm; per offset it cannot."""
    return torch.cat([layers.rmsnorm(x[:, i:i + 1].contiguous(), weight, eps)
                      for i in range(x.shape[1])], dim=1)


def _dense_attn_block(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                      cfg: ModelConfig, pos: torch.Tensor,
                      active: Optional[torch.Tensor]) -> torch.Tensor:
    q, k, v = _qkv_at(p, x, cfg, pos)
    k_cache, v_cache = layer["k"], layer["v"]
    b, t = x.shape[0], k_cache.shape[2]
    if cfg.attn_window is not None:
        slot = pos % t                       # rolling buffer
    else:
        slot = torch.clamp(pos, max=t - 1)
    rows = torch.arange(b, device=x.device)
    slot = slot.long().expand(b)
    for cache_rows, new in ((k_cache, k), (v_cache, v)):
        new = new[:, :, 0].to(cache_rows.dtype)           # (B, HK, D)
        if active is not None:               # inactive slots keep their row
            new = torch.where(active[:, None, None], new,
                              cache_rows[rows, :, slot])
        cache_rows[rows, :, slot] = new
    out = attn_lib.decode_attention(q, k_cache, v_cache, pos=pos,
                                    window=cfg.attn_window)
    return _finish_block(p, x, out, cfg)


def _recurrent_block(btype: str, p: Params, x: torch.Tensor,
                     layer: Dict[str, Any], cfg: ModelConfig,
                     active: Optional[torch.Tensor]) -> torch.Tensor:
    """One token of a recurrent layer.  The slot-major state is written in
    place; an inactive slot keeps its state bit for bit."""
    _, step, args = _recurrent(cfg, btype)
    state = layer[btype]
    h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, new = step(p[btype], h_in, state, args, cfg.compute_dtype)
    for name, t in state.items():
        upd = new[name]
        if active is not None:
            upd = torch.where(active.reshape((-1,) + (1,) * (t.dim() - 1)),
                              upd, t)
        t.copy_(upd)
    return _recurrent_out(p, x, y, btype, cfg)


def _decode_layers(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                   tokens: torch.Tensor, active: Optional[torch.Tensor],
                   attn_block) -> torch.Tensor:
    """Embed, every layer in order (``attn_block(p, x, layer)`` for an
    attention layer, the shared recurrent step otherwise), the head: the one
    body the dense, paged and static steps share."""
    x = _embed(params, tokens, cfg)
    for btype, p, layer in zip(cfg.layer_types(), params["layers"],
                               cache["layers"]):
        if btype in RECURRENT:
            x = _recurrent_block(btype, p, x, layer, cfg, active)
        else:
            x = attn_block(p, x, layer)
    return _logits(params, x, cfg)


def _decode_step_impl(params: Params, cfg: ModelConfig,
                      cache: Dict[str, Any], tokens: torch.Tensor,
                      active: Optional[torch.Tensor]):
    _check_decoder_only(cfg)
    pos = cache["pos"]
    logits = _decode_layers(
        params, cfg, cache, tokens, active,
        lambda p, x, layer: _dense_attn_block(p, x, layer, cfg, pos, active))
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
    inactive slot keeps its rows, states and position.  The per-slot math is
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
    names it.  One table row serves every layer.  Recurrent states stay
    slot-major, as in the dense layout (they are O(1) in sequence length).
    Sliding-window configs must serve on the dense layout.
    """
    _check_decoder_only(cfg)
    if cfg.attn_window is not None:
        raise ValueError(
            "paged KV layout does not support sliding-window attention "
            "(rolling-buffer slots); serve this config with the dense "
            "layout")
    blocks_per_slot = -(-max_seq // block_size)
    if total_blocks is None:
        total_blocks = n_slots * blocks_per_slot
    shape = (total_blocks + 1, cfg.n_kv_heads, block_size, cfg.hd)
    return {"layers": _layer_entries(cfg, n_slots, shape, device),
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
            "block_tables": torch.zeros((n_slots, blocks_per_slot),
                                        dtype=torch.int32, device=device)}


def _paged_attn_block(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                      cfg: ModelConfig, pos: torch.Tensor,
                      block_tables: torch.Tensor, active: torch.Tensor,
                      max_seq: int) -> torch.Tensor:
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
    return _finish_block(p, x, out, cfg)


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
        lambda p, x, layer: _paged_attn_block(p, x, layer, cfg, pos,
                                              block_tables, active, max_seq))
    pos.copy_(torch.where(active, pos + 1, pos))
    return logits, cache


def _multi_attn_block_paged(p: Params, x: torch.Tensor, layer: Dict[str, Any],
                            cfg: ModelConfig, pos: torch.Tensor,
                            block_tables: torch.Tensor, active: torch.Tensor,
                            max_seq: int, stepwise: bool) -> torch.Tensor:
    """Verification-window counterpart of :func:`_paged_attn_block`: x is
    (B, M, d), M consecutive tokens per slot at positions pos..pos+M-1,
    whose K/V goes into the slot's pages in one ``index_put_``; each query
    attends over cache slots <= its own position (the freshly written
    window prefix included, as M sequential single-token steps see it).
    ``stepwise``: the norms and the attention per window offset, in the
    single-token step's shapes."""
    norm = rmsnorm_multi if stepwise else rmsnorm
    h_in = norm(x, p["ln1"], cfg.norm_eps)
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
        q, k_arena, v_arena, block_tables, pos, max_seq=max_seq,
        stepwise=stepwise)
    return _finish_block(p, x, out, cfg, norm)


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
    every window offset in ONE step (speculative verification), and feeding
    a prompt chunk replays prefill M tokens at a time (the draft's
    catch-up).

    ``stepwise`` (the verify) runs the norms and the attention, whose
    rounding on a card depends on how many rows one call holds, once per
    window offset in the single-token step's shapes.  The projections, the
    MLP (a MoE's router included) and the head run over all B·M rows at
    once, so an offset's numbers equal a plain step's only where the GEMM
    library rounds row i of the (B·M)-row product as it rounds the B-row
    product.  On the CPU it does, and speculation commits plain decoding's
    tokens.  On an H100 ``chip_smoke.py`` phase 7 gates that for
    qwen2-1.5B at 8 slots x 3 tokens (24 rows); at 32 slots x 5 tokens
    (160 rows) cuBLAS rounds the MLP's down projection otherwise (from 89
    rows) and the tokens drift.  False runs the norms and the attention
    over the whole window at once: the draft's catch-up, whose numbers only
    steer proposals; per offset, its prompt-long windows cut forced
    speculation's tok/s ~6x on an H100 (``chip_smoke.py`` phase 10).

    ``advance`` True moves each active slot's position by M; False leaves
    ``pos`` alone so the caller commits only the accepted prefix.
    Positions pos+c..pos+M-1 then hold *stale* K/V from the rejected tail,
    which is safe: every later feed starts at the committed position and
    rewrites forward before attention reaches them (attention masks
    kv_slot <= query position).

    Everything is in place, as in :func:`decode_step_slots_paged`: the
    arenas through ``index_put_``, ``pos`` through ``copy_``, so a CUDA graph
    of a step that calls this reads and writes the cache's own buffers.
    The attention is the gather path whatever ``cfg.paged_attention_impl``
    says: there is no multi-query kernel.  Requires an all-attention
    config.
    """
    if any(t != "attn" for t in cfg.layer_types()):
        raise ValueError(
            "multi-token slot step requires an all-attention config: "
            "recurrent/SSM layer state has no multi-token slot step")
    pos = cache["pos"]
    block_tables = cache["block_tables"]
    x = _embed(params, tokens, cfg)
    for p, layer in zip(params["layers"], cache["layers"]):
        x = _multi_attn_block_paged(p, x, layer, cfg, pos, block_tables,
                                    active, max_seq, stepwise)
    logits = _logits(params, x, cfg, rmsnorm_multi if stepwise else None)
    if advance:
        pos.copy_(torch.where(active, pos + tokens.shape[1], pos))
    return logits, cache
