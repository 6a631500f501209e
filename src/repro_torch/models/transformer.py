"""The config-driven transformer, dense all-attention path (qwen2, llama-style
decoders): full-sequence forward (training shape and prefill), the decode
step over a dense cache (the static server's; a rolling buffer for windowed
configs), and the slot decode steps the serving engine runs, on the dense
slot cache and on the block-paged one.

Plain functions on explicit parameters, as in the JAX package: ``params`` is
a dict holding ``embed`` (V, D), ``final_norm`` (D,), ``layers`` — one dict
per layer with ``ln1``, ``attn`` (``wq wk wv wo`` [+ ``bq bk bv``]),
``ln2``, ``mlp`` (``w_gate w_up w_down``) — and ``lm_head`` when embeddings
are untied.  The JAX package stacks layers for ``lax.scan``;
``models.convert.params_from_numpy`` unstacks its tree into this layout.

Unlike the JAX package's pure functions, the decode steps update the cache
in place (the KV rows or arenas, the positions): it is the serving engine's
state, copying a 28-layer cache every token would double the step's traffic,
and a CUDA graph replaying the step reads and writes the same buffers.

MoE, SSM and recurrent blocks, cross-attention and the encoder-decoder are
not ported yet: configs that need them are refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn_lib
from .layers import apply_rope, rmsnorm, swiglu

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
    block_pattern: Tuple[str, ...] = ("attn",)
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

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_types(self) -> List[str]:
        unit = self.block_pattern
        return [unit[i % len(unit)] for i in range(self.n_layers)]


def _check_dense(cfg: ModelConfig) -> None:
    other = sorted(set(cfg.layer_types()) - {"attn"})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer types {other} are not ported yet; the port "
            "runs dense all-attention configs")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes, in the layout this module reads."""
    _check_dense(cfg)
    d, h, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
            "wo": (h * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
    mlp = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.gated_mlp:
        mlp["w_gate"] = (d, f)
    layer = {"ln1": (d,), "attn": attn, "ln2": (d,), "mlp": mlp}
    shapes: Params = {"embed": (cfg.vocab, d), "final_norm": (d,),
                      "layers": [layer] * cfg.n_layers}
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
    matrices, N(0, 0.02) embeddings, zero norms and biases (the JAX
    package's init; the two frameworks' generators give other numbers)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name, shape):
        if len(shape) == 1:
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        std = 0.02 if name == "embed" else (2.0 / shape[0]) ** 0.5
        return (torch.randn(shape, generator=gen, device=device) * std).to(
            cfg.param_dtype)

    return map_params(make, param_shapes(cfg))


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """The parameters with every matrix and bias cast to the compute dtype
    once, norms left as they are.  The layers cast each weight to the compute
    dtype where they use it, so this changes no number: it only keeps a
    decode step from re-casting 1.5B weights every token."""
    def cast(name, t):
        if name.startswith("ln") or name == "final_norm":
            return t
        return t.to(cfg.compute_dtype)

    return map_params(cast, params)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count, the JAX package's formula for dense configs."""
    _check_dense(cfg)
    d, h, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = d * h * hd + 2 * d * hk * hd + h * hd * d
    if cfg.qkv_bias:
        attn += h * hd + 2 * hk * hd
    mlp = (3 if cfg.gated_mlp else 2) * d * f
    total = cfg.n_layers * (attn + mlp) + cfg.vocab * d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    return total


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


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    m = p["mlp"]
    h_in = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.gated_mlp:
        return x + swiglu(h_in, m["w_gate"], m["w_up"], m["w_down"], cd)
    h = F.gelu(h_in @ m["w_up"].to(cd), approximate="tanh")
    return x + h @ m["w_down"].to(cd)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head.to(cfg.compute_dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (training shape, prefill)
# ---------------------------------------------------------------------------
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            emit_cache: bool = False):
    """tokens (B, S) int -> (logits (B, S, V), cache or None).

    With ``emit_cache`` (prefill) the cache holds every layer's K/V in the
    compute dtype, ``{"layers": [{"k", "v"}, ...], "pos": S}``; with an
    ``attn_window`` shorter than S, only the last ``attn_window`` positions,
    position p in slot p % attn_window, as the JAX package keeps them.  Attention
    runs through ``cfg.attention_impl``; ``hopper`` launches the
    flash-attention kernel once per layer on a CUDA tensor."""
    _check_dense(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    caches = []
    for p in params["layers"]:
        h_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(p["attn"], h_in, cfg)
        q = apply_rope(q, positions[None, None], cfg.rope_theta)
        k = apply_rope(k, positions[None, None], cfg.rope_theta)
        out = attn_lib.attend(q, k, v, impl=cfg.attention_impl, causal=True,
                              window=cfg.attn_window,
                              kv_chunk=cfg.attn_chunk)
        x = x + _merge_heads(out, p["attn"], cfg)
        x = _mlp(p, x, cfg)
        if emit_cache:
            w = cfg.attn_window
            if w is not None and k.shape[2] > w:
                # rolling buffer of the last w positions, position p in slot
                # p % w: the layout a windowed decode step writes and reads
                t = k.shape[2]
                idx = torch.arange(w, device=k.device) + (t // w) * w
                idx = torch.where(idx < t, idx, idx - w)
                k, v = k[:, :, idx], v[:, :, idx]
            caches.append({"k": k.to(cfg.compute_dtype),
                           "v": v.to(cfg.compute_dtype)})
    logits = _logits(params, x, cfg)
    if not emit_cache:
        return logits, None
    return logits, {"layers": caches,
                    "pos": torch.tensor(tokens.shape[1], dtype=torch.int32)}


# ---------------------------------------------------------------------------
# Decode: one token per sequence against a cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict[str, Any]:
    """Dense decode cache: each layer's K and V as ``(batch, n_kv_heads, t,
    head_dim)`` in the compute dtype, ``t = min(attn_window, max_seq)`` (a
    rolling buffer, position p in slot p % t, for a windowed config), and
    one position ``pos`` shared by the batch."""
    _check_dense(cfg)
    t = min(cfg.attn_window or max_seq, max_seq)
    shape = (batch, cfg.n_kv_heads, t, cfg.hd)

    def rows():
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

    return {"layers": [{"k": rows(), "v": rows()}
                       for _ in range(cfg.n_layers)],
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
    either slot layout: its position.  KV rows and pages need no clearing
    (position masks hide stale entries), and the paged block tables
    survive.  In place; returns the cache."""
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
                  cfg: ModelConfig) -> torch.Tensor:
    x = x + _merge_heads(out, p["attn"], cfg)
    return _mlp(p, x, cfg)


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


def _decode_step_impl(params: Params, cfg: ModelConfig,
                      cache: Dict[str, Any], tokens: torch.Tensor,
                      active: Optional[torch.Tensor]):
    _check_dense(cfg)
    pos = cache["pos"]
    x = _embed(params, tokens, cfg)
    for p, layer in zip(params["layers"], cache["layers"]):
        x = _dense_attn_block(p, x, layer, cfg, pos, active)
    logits = _logits(params, x, cfg)
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
    position and the position advances; an inactive slot keeps its rows and
    position.  The per-slot math is :func:`decode_step`'s, which makes
    continuous batching's tokens those of the static server.  Returns
    (logits (B, 1, V), cache), the cache updated in place.
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

    Each layer keeps K and V in one ``(total_blocks + 1, n_kv_heads,
    block_size, head_dim)`` arena each, in the compute dtype; a slot's
    sequence lives in the pages its ``block_tables`` row names (page ``j``
    holds positions ``[j * block_size, (j + 1) * block_size)``).  The last
    page is the trash page: inactive slots write there, and no table names
    it.  One table row serves every layer.
    """
    _check_dense(cfg)
    if cfg.attn_window is not None:
        raise ValueError(
            "paged KV layout does not support sliding-window attention "
            "(rolling-buffer slots)")
    blocks_per_slot = -(-max_seq // block_size)
    if total_blocks is None:
        total_blocks = n_slots * blocks_per_slot
    shape = (total_blocks + 1, cfg.n_kv_heads, block_size, cfg.hd)

    def arena():
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

    return {"layers": [{"k": arena(), "v": arena()}
                       for _ in range(cfg.n_layers)],
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
    written into its page at ``pos`` and its position advances by one; an
    inactive slot writes to the trash page and keeps its position and live
    pages.  Returns (logits (B, 1, V), cache), the cache updated in place
    (``pos`` too: a CUDA graph of the step reads the same buffer).
    """
    pos = cache["pos"]
    block_tables = cache["block_tables"]
    x = _embed(params, tokens, cfg)
    for p, layer in zip(params["layers"], cache["layers"]):
        x = _paged_attn_block(p, x, layer, cfg, pos, block_tables, active,
                              max_seq)
    logits = _logits(params, x, cfg)
    pos.copy_(torch.where(active, pos + 1, pos))
    return logits, cache
