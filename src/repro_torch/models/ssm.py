"""State-space blocks: Mamba-1 (falcon-mamba) and RG-LRU (recurrentgemma).

Plain functions on tensors with the JAX package's numerics: projections in
the compute dtype, the recurrence in fp32, and the causal-conv state stored
in bf16 whatever the compute dtype (the JAX package rounds it there between
calls, so a prefill-then-step run differs from a full forward in the same
way in both frameworks).

The full-sequence forms run the diagonal recurrence h_t = a_t h_{t-1} + b_t
as a two-level scan: sequentially over segments of ``chunk`` positions,
carrying the state, and within a segment as an inclusive Hillis-Steele scan
over the segment axis (log2(chunk) doubling steps of whole-segment products).
The (B, L, d_inner, d_state) tensor is never materialized, only one
segment's.  Products are formed directly, never through exp(cumsum(log a)),
which loses precision as a approaches 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MambaArgs:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)


def mamba_param_shapes(args: MambaArgs) -> Dict[str, tuple]:
    """The JAX package's ``init_mamba_params`` layout."""
    d, di, n, r = args.d_model, args.d_inner, args.d_state, args.dt_rank
    return {"in_proj": (d, 2 * di), "conv_w": (args.d_conv, di),
            "conv_b": (di,), "x_proj": (di, r + 2 * n), "dt_proj": (r, di),
            "dt_bias": (di,), "A_log": (di, n), "D": (di,),
            "out_proj": (di, d)}


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma recurrent block)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RGLRUArgs:
    d_model: int
    d_conv: int = 4
    expand: int = 1       # recurrentgemma: lru_width == d_model
    c: float = 8.0
    chunk: int = 512

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def rglru_param_shapes(args: RGLRUArgs) -> Dict[str, tuple]:
    """The JAX package's ``init_rglru_params`` layout."""
    d, di = args.d_model, args.d_inner
    return {"x_proj": (d, di), "gate_proj": (d, di),
            "conv_w": (args.d_conv, di), "conv_b": (di,), "w_a": (di, di),
            "b_a": (di,), "w_i": (di, di), "b_i": (di,), "lambda": (di,),
            "out_proj": (di, d)}


def init_leaf(name: str, shape: tuple, generator: torch.Generator,
              device, c: float = RGLRUArgs.c) -> Optional[torch.Tensor]:
    """The JAX package's draw for the blocks' leaves that are neither
    He-normal matrices nor zeros, in fp32; None for every other leaf.
    The conv filter is N(0, 0.01), ``dt_bias`` softplus^-1(0.01), ``A_log``
    log(1..d_state) per channel, ``D`` ones, and Λ spreads a = σ(Λ)^c over
    (0.9, 0.999)."""
    if name == "conv_w":
        return torch.randn(shape, generator=generator, device=device) * 0.1
    if name == "dt_bias":
        return torch.full(shape, -4.6, device=device)
    if name == "A_log":
        a = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).clone()
    if name == "D":
        return torch.ones(shape, device=device)
    if name == "lambda":
        u = 0.9 + 0.099 * torch.rand(shape, generator=generator,
                                     device=device)
        return torch.log(u ** (1.0 / c) / (1 - u ** (1.0 / c)))
    return None


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over L.  x: (B, L, DI); w: (K, DI).
    ``state``: (B, K-1, DI) trailing context from the previous call
    (decode).  Returns (y, new_state); the taps sum in the JAX package's
    order."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                # (B, L+K-1, DI)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y + b, xp[:, -(k - 1):, :]


def _segment_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t over axis 1.
    a/b: (B, C, ...); h0: (B, ...).  Returns (h_all, h_last).  An inclusive
    Hillis-Steele scan: after the step at ``off``, position t holds the
    composition of positions (t - 2 off, t]."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    h_all = b + a * h0[:, None]
    return h_all, h_all[:, -1]


def _chunks(length: int, chunk: int):
    chunk = min(chunk, length)
    if length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the scan chunk {chunk}")
    return [slice(i, i + chunk) for i in range(0, length, chunk)]


def _conv_state(conv: torch.Tensor) -> torch.Tensor:
    return conv.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------
def _mamba_in(params: Params, x: torch.Tensor, args: MambaArgs, cd,
              conv_state: Optional[torch.Tensor]):
    """Input projection, causal conv and the selective parameters:
    (xc, z, dt fp32, B, C, new conv state)."""
    r, n = args.dt_rank, args.d_state
    xz = x.to(cd) @ params["in_proj"].to(cd)
    xc, z = torch.chunk(xz, 2, dim=-1)
    xc, conv = _causal_conv(xc, params["conv_w"].to(cd),
                            params["conv_b"].to(cd), conv_state)
    xc = F.silu(xc)
    dbc = xc @ params["x_proj"].to(cd)
    dt, bm, cm = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"].to(cd)
                    + params["dt_bias"].to(cd)).float()
    return xc, z, dt, bm, cm, conv


def _mamba_out(params: Params, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, out_dtype, cd) -> torch.Tensor:
    y = y + params["D"].to(cd) * xc
    y = y * F.silu(z)
    return (y @ params["out_proj"].to(cd)).to(out_dtype)


def mamba_apply(params: Params, x: torch.Tensor, args: MambaArgs,
                compute_dtype=torch.bfloat16, return_state: bool = False):
    """x: (B, L, D) -> (B, L, D); the full-sequence block (prefill).  L must
    be a multiple of ``min(args.chunk, L)``.  With ``return_state``, also
    returns the decode state {"h", "conv"} :func:`mamba_step` continues."""
    cd = compute_dtype
    b, length, _ = x.shape
    xc, z, dt, bm, cm, conv = _mamba_in(params, x, args, cd, None)
    a_mat = -torch.exp(params["A_log"].float())              # (DI, N)
    h = torch.zeros((b, args.d_inner, args.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for sl in _chunks(length, args.chunk):
        dt_c = dt[:, sl]                                     # (B, C, DI)
        da = torch.exp(dt_c[..., None] * a_mat)              # (B, C, DI, N)
        dbx = (dt_c * xc[:, sl].float())[..., None] \
            * bm[:, sl].float()[:, :, None, :]
        h_all, h = _segment_scan(da, dbx, h)
        y = torch.einsum("bcdn,bcn->bcd", h_all, cm[:, sl].float())
        ys.append(y.to(cd))
    out = _mamba_out(params, torch.cat(ys, dim=1), xc, z, x.dtype, cd)
    if return_state:
        return out, {"h": h, "conv": _conv_state(conv)}
    return out


def mamba_init_state(args: MambaArgs, batch: int, *, device="cuda") -> State:
    return {"h": torch.zeros((batch, args.d_inner, args.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, args.d_conv - 1, args.d_inner),
                                dtype=torch.bfloat16, device=device)}


def mamba_step(params: Params, x: torch.Tensor, state: State,
               args: MambaArgs, compute_dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x: (B, 1, D).  Returns (out, new state); the
    state passed in is not written."""
    cd = compute_dtype
    xc, z, dt, bm, cm, conv = _mamba_in(params, x, args, cd,
                                        state["conv"].to(cd))
    a_mat = -torch.exp(params["A_log"].float())
    da = torch.exp(dt[:, 0, :, None] * a_mat)                # (B, DI, N)
    dbx = (dt[:, 0] * xc[:, 0].float())[..., None] \
        * bm[:, 0].float()[:, None, :]
    h = da * state["h"] + dbx
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0].float())[:, None]
    out = _mamba_out(params, y.to(cd), xc, z, x.dtype, cd)
    return out, {"h": h, "conv": _conv_state(conv)}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru_gates(params: Params, xc: torch.Tensor, args: RGLRUArgs, cd):
    r = torch.sigmoid(xc @ params["w_a"].to(cd)
                      + params["b_a"].to(cd)).float()
    i = torch.sigmoid(xc @ params["w_i"].to(cd)
                      + params["b_i"].to(cd)).float()
    log_a1 = -F.softplus(-params["lambda"].float())          # log σ(Λ)
    log_a = args.c * r * log_a1                              # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * xc.float()


def _rglru_in(params: Params, x: torch.Tensor, args: RGLRUArgs, cd,
              conv_state: Optional[torch.Tensor]):
    xc = x.to(cd) @ params["x_proj"].to(cd)
    xc, conv = _causal_conv(xc, params["conv_w"].to(cd),
                            params["conv_b"].to(cd), conv_state)
    a, bx = _rglru_gates(params, xc, args, cd)
    return a, bx, conv


def _rglru_out(params: Params, h: torch.Tensor, x: torch.Tensor,
               cd) -> torch.Tensor:
    gate = F.gelu(x.to(cd) @ params["gate_proj"].to(cd), approximate="tanh")
    return ((h * gate) @ params["out_proj"].to(cd)).to(x.dtype)


def rglru_apply(params: Params, x: torch.Tensor, args: RGLRUArgs,
                compute_dtype=torch.bfloat16, return_state: bool = False):
    """The full-sequence RG-LRU branch.  x: (B, L, D) -> (B, L, D); L a
    multiple of ``min(args.chunk, L)``.  With ``return_state``, also
    returns the decode state {"h", "conv"}."""
    cd = compute_dtype
    b, length, _ = x.shape
    a, bx, conv = _rglru_in(params, x, args, cd, None)
    h = torch.zeros((b, args.d_inner), dtype=torch.float32, device=x.device)
    ys = []
    for sl in _chunks(length, args.chunk):
        h_all, h = _segment_scan(a[:, sl], bx[:, sl], h)
        ys.append(h_all.to(cd))
    out = _rglru_out(params, torch.cat(ys, dim=1), x, cd)
    if return_state:
        return out, {"h": h, "conv": _conv_state(conv)}
    return out


def rglru_init_state(args: RGLRUArgs, batch: int, *, device="cuda") -> State:
    return {"h": torch.zeros((batch, args.d_inner), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, args.d_conv - 1, args.d_inner),
                                dtype=torch.bfloat16, device=device)}


def rglru_step(params: Params, x: torch.Tensor, state: State,
               args: RGLRUArgs, compute_dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x: (B, 1, D).  Returns (out, new state); the
    state passed in is not written."""
    cd = compute_dtype
    a, bx, conv = _rglru_in(params, x, args, cd, state["conv"].to(cd))
    h = a[:, 0] * state["h"] + bx[:, 0]
    out = _rglru_out(params, h[:, None].to(cd), x, cd)
    return out, {"h": h, "conv": _conv_state(conv)}
