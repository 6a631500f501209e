"""Phase placement: price prefill and decode separately over engines.

CNNLab's middleware prices every network stage on every accelerator and
offloads each stage where the user's objective wins (§III.A, Fig. 6).
Serving decomposes into exactly two stages with opposite rooflines —
prefill (seq-long matmuls, compute-bound) and decode (one token against a
long KV cache, memory-bound) — so the same design-space exploration
applies: enumerate (prefill engine, decode engine) pairs, price each phase
with ``core/cost_model.py`` on that engine's device model, price the
phase-boundary hand-off with the offload-overhead model (``transfer_cost``:
KV rows at link bandwidth), and pick the pair minimizing the objective.
Colocated pairs pay no hand-off, so the analyzer chooses colocation exactly
when the boundary overhead dominates the per-phase wins.

The JAX package's ``serving/placement.py``, priced to the same floats.
``price="measured"`` swaps each *buildable* engine's analytic model for one
calibrated from the profile cache (:mod:`repro_torch.profiling`) when the
cache holds measurements for it on this device, degrading per-engine to
analytic otherwise.  ``choose_speculation`` prices draft-model speculative
decoding against plain decode the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..core import cost_model
from ..core.cost_model import TransferCost, layer_cost, transfer_cost
from ..core.engines import PLACEMENT_ENGINES, ExecutionEngine
from ..core.layer_model import NetworkSpec
from ..models.transformer import ModelConfig
from .batcher import phase_network_spec, step_time_model

OBJECTIVES = ("latency", "energy", "edp", "perf_density")


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One phase priced on one engine's device model."""

    phase: str                           # "prefill" | "decode"
    engine: str
    device: str
    time_s: float
    energy_j: float
    flops: int
    peak_power_w: float


@dataclasses.dataclass(frozen=True)
class PairScore:
    """One (prefill engine, decode engine) candidate, fully priced."""

    prefill: PhaseCost
    decode: PhaseCost
    handoff: TransferCost
    objective: str

    @property
    def colocated(self) -> bool:
        return self.prefill.engine == self.decode.engine

    @property
    def total_time_s(self) -> float:
        return self.prefill.time_s + self.handoff.t_transfer + self.decode.time_s

    @property
    def total_energy_j(self) -> float:
        return (self.prefill.energy_j + self.handoff.energy_j
                + self.decode.energy_j)

    @property
    def total_flops(self) -> int:
        return self.prefill.flops + self.decode.flops

    @property
    def value(self) -> float:
        """Objective value — lower is better, like cost_model.objective_value."""
        if self.objective == "latency":
            return self.total_time_s
        if self.objective == "energy":
            return self.total_energy_j
        if self.objective == "edp":
            return self.total_energy_j * self.total_time_s
        if self.objective == "perf_density":
            # maximize GFLOP/J -> minimize its inverse (joules per GFLOP)
            return self.total_energy_j / (self.total_flops / 1e9)
        raise ValueError(f"unknown placement objective: {self.objective!r}")


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """The DSE result: the winning pair plus the ranked alternatives."""

    objective: str
    pricing: str
    best: PairScore
    ranked: Tuple[PairScore, ...]        # all candidates, best first

    @property
    def prefill_engine(self) -> str:
        return self.best.prefill.engine

    @property
    def decode_engine(self) -> str:
        return self.best.decode.engine

    @property
    def colocated(self) -> bool:
        return self.best.colocated

    def summary(self) -> str:
        rows = [f"phase placement ({self.objective}, {self.pricing} pricing)",
                f"{'prefill':<14} {'decode':<14} {'prefill':>11} "
                f"{'handoff':>11} {'decode':>11} {'value':>12}"]
        for p in self.ranked:
            mark = " <- chosen" if p is self.ranked[0] else ""
            rows.append(
                f"{p.prefill.engine:<14} {p.decode.engine:<14} "
                f"{p.prefill.time_s*1e3:>9.3f}ms "
                f"{p.handoff.t_transfer*1e3:>9.3f}ms "
                f"{p.decode.time_s*1e3:>9.3f}ms {p.value:>12.4g}{mark}")
        b = self.best
        rows.append(
            f"chosen: prefill={b.prefill.engine} "
            f"(t={b.prefill.time_s*1e3:.3f}ms, e={b.prefill.energy_j:.4f}J) "
            f"decode={b.decode.engine} "
            f"(t={b.decode.time_s*1e3:.3f}ms, e={b.decode.energy_j:.4f}J) "
            f"handoff={b.handoff.bytes_moved}B/"
            f"{b.handoff.t_transfer*1e3:.3f}ms "
            f"[{'colocated' if b.colocated else 'disaggregated'}]")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# Phase workloads + hand-off payload
# ---------------------------------------------------------------------------
def prefill_network_spec(cfg: ModelConfig, prompt_len: int) -> NetworkSpec:
    """The prefill phase's workload: the whole prompt in one causal pass."""
    return phase_network_spec(cfg, seq=prompt_len, kv_len=prompt_len)


def handoff_payload_bytes(cfg: ModelConfig, prompt_len: int, *,
                          dtype_bytes: int = 2,
                          slot_len: Optional[int] = None) -> int:
    """Analytic per-request phase-boundary payload: the prompt's KV rows
    for every attention layer, recurrent states for SSM layers, and the
    d_model activation / sampled-token hand-off.

    ``slot_len`` prices what the slot engines' transport moves: whole
    physical slot rows (``max_seq`` KV positions plus the int32
    prompt/output buffers), not just the logical prefix.  ``None`` prices
    the logical payload (what an ideal block-paged transport would move)."""
    total = cfg.d_model * dtype_bytes
    di = cfg.ssm_expand * cfg.d_model
    kv_rows = slot_len or prompt_len
    for btype in cfg.layer_types():
        if btype in ("attn", "xattn"):
            t = min(cfg.attn_window or kv_rows, kv_rows)
            total += 2 * cfg.n_kv_heads * cfg.hd * t * dtype_bytes
        elif btype == "rec":
            total += di * dtype_bytes
        elif btype == "mamba":
            total += (di * cfg.ssm_state + di * cfg.ssm_conv) * dtype_bytes
    if slot_len is not None:
        total += 2 * slot_len * 4        # int32 prompt row + output row
    return total


def phase_cost(cfg: ModelConfig, engine: ExecutionEngine, phase: str, *,
               prompt_len: int, gen_len: int, batch: int = 1,
               dtype_bytes: int = 2, device=None) -> PhaseCost:
    """Price one serving phase on one engine.

    Prefill is the full-sequence pass; decode is ``gen_len`` per-token
    steps, each priced at the worst-case context the phase serves
    (``prompt_len + gen_len``).  ``device`` overrides the engine's own
    model (a profiling-calibrated one, placement's measured pricing).
    """
    device = device or engine.device
    if phase == "prefill":
        net = prefill_network_spec(cfg, prompt_len)
        steps = 1
    elif phase == "decode":
        net = phase_network_spec(cfg, seq=1, kv_len=prompt_len + gen_len)
        steps = max(gen_len - 1, 0)      # the first sample lands in prefill
    else:
        raise ValueError(f"unknown phase: {phase!r}")
    t = e = 0.0
    flops = 0
    peak = 0.0
    eff = engine.efficiency if device.analytic else 1.0
    for spec in net:
        if not engine.supports(spec):
            raise ValueError(
                f"engine {engine.name} does not run {spec.kind} "
                f"(needed by {cfg.name}'s {phase} phase)")
        c = layer_cost(spec, device, batch=batch, dtype_bytes=dtype_bytes,
                       mxu_efficiency=eff)
        t += c.t_total
        e += c.energy_j
        flops += c.flops
        peak = max(peak, c.power_w)
    return PhaseCost(phase=phase, engine=engine.name, device=device.name,
                     time_s=t * steps, energy_j=e * steps,
                     flops=flops * steps, peak_power_w=peak)


def drift_scaled_device(device, ratio: float):
    """De-rate (ratio > 1) or up-rate (ratio < 1) a device model by an
    observed/priced time ratio: a phase whose observed step cost runs
    ``ratio``x its price behaves like a device whose every rate is
    ``1/ratio`` of nominal."""
    if ratio <= 0.0:
        raise ValueError("drift ratio must be > 0")
    return dataclasses.replace(
        device,
        name=f"{device.name}-drift{ratio:.3g}x",
        peak_flops=device.peak_flops / ratio,
        mem_bw=device.mem_bw / ratio,
        throughput={k: v / ratio for k, v in device.throughput.items()},
        throughput_bwd={k: v / ratio
                        for k, v in device.throughput_bwd.items()})


# ---------------------------------------------------------------------------
# The DSE itself
# ---------------------------------------------------------------------------
def _load_cache(cache_path: Optional[str], device):
    from ..profiling import cache as cache_lib
    return cache_lib.ProfileCache.load(
        cache_path or cache_lib.DEFAULT_CACHE_PATH, strict=False,
        device=device)


def _measured_devices(engines: Sequence[ExecutionEngine],
                      cache_path: Optional[str],
                      device="cuda") -> Dict[str, object]:
    """Per-engine calibrated device models from the profile cache, for the
    engines it holds measurements for in ``device``'s environment.  Missing
    / empty caches degrade cleanly to {} (analytic for everyone)."""
    from ..profiling import Measurement, calibrate_engine
    cache = _load_cache(cache_path, device)
    out: Dict[str, object] = {}
    for eng in engines:
        if not eng.buildable:
            continue                     # nothing measurable to calibrate
        ms = [Measurement.from_dict(d)
              for d in cache.measurements(engine=eng.name)]
        if ms:
            out[eng.name] = calibrate_engine(eng, ms)
    return out


def _measured_link_bw(cache_path: Optional[str],
                      device="cuda") -> Optional[float]:
    """The profile cache's measured inter-device copy bandwidth (bytes/s)
    for ``device``'s environment, or None when none was recorded — the
    measured counterpart of ``transfer_cost``'s datasheet fallback."""
    from ..profiling import cached_link_bw
    return cached_link_bw(_load_cache(cache_path, device))


def place_phases(
    cfg: ModelConfig,
    engines: Optional[Sequence[ExecutionEngine]] = None,
    *,
    objective: str = "latency",
    prompt_len: int,
    gen_len: int,
    batch: int = 1,
    dtype_bytes: int = 2,
    price: str = "analytic",
    cache_path: Optional[str] = None,
    link_bw: Optional[float] = None,
    device_overrides: Optional[Dict[str, object]] = None,
    device="cuda",
) -> PlacementDecision:
    """Enumerate (prefill, decode) engine pairs and pick per objective.

    ``engines`` defaults to ``core.engines.PLACEMENT_ENGINES`` (the
    buildable torch engine plus the paper boards' roofline twins).  Engines
    that cannot run one of the model's layer kinds are skipped.
    ``price="measured"`` reads the profile cache under ``device``'s
    environment: buildable engines with measurements are priced on
    calibrated models, and the hand-off at the cache's measured copy rate
    when one was recorded (:mod:`repro_torch.profiling.transfer`) — an
    explicit ``link_bw`` still wins over both.  ``device_overrides`` maps
    engine name -> device model and wins over the measured calibration.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown placement objective: {objective!r} "
                         f"(pick from {OBJECTIVES})")
    if price not in ("analytic", "measured"):
        raise ValueError(f"unknown pricing source: {price!r}")
    engines = tuple(engines if engines is not None else PLACEMENT_ENGINES)
    overrides = dict(_measured_devices(engines, cache_path, device)
                     if price == "measured" else {})
    if device_overrides:
        overrides.update(device_overrides)
    if link_bw is None and price == "measured":
        link_bw = _measured_link_bw(cache_path, device)

    needed_kinds = {spec.kind
                    for spec in phase_network_spec(cfg, seq=1, kv_len=2)}
    per_phase: Dict[str, Dict[str, PhaseCost]] = {"prefill": {}, "decode": {}}
    for eng in engines:
        if not needed_kinds.issubset(eng.kinds):
            continue                     # engine lacks a needed layer kind
        for phase in ("prefill", "decode"):
            per_phase[phase][eng.name] = phase_cost(
                cfg, eng, phase, prompt_len=prompt_len, gen_len=gen_len,
                batch=batch, dtype_bytes=dtype_bytes,
                device=overrides.get(eng.name))
    if not per_phase["prefill"] or not per_phase["decode"]:
        raise ValueError(f"no candidate engine runs {cfg.name}'s layer kinds")

    by_name = {e.name: e for e in engines}
    # priced at the slot-row size the disaggregated loop actually migrates
    payload = handoff_payload_bytes(
        cfg, prompt_len, dtype_bytes=dtype_bytes,
        slot_len=prompt_len + gen_len) * batch
    scores = []
    for p_name, pc in per_phase["prefill"].items():
        for d_name, dc in per_phase["decode"].items():
            src = overrides.get(p_name) or by_name[p_name].device
            dst = overrides.get(d_name) or by_name[d_name].device
            hand = transfer_cost(0 if p_name == d_name else payload,
                                 src, dst, link_bw=link_bw)
            scores.append(PairScore(prefill=pc, decode=dc, handoff=hand,
                                    objective=objective))
    # deterministic tie-break: objective value, colocation first, names
    scores.sort(key=lambda s: (s.value, not s.colocated,
                               s.prefill.engine, s.decode.engine))
    return PlacementDecision(objective=objective, pricing=price,
                             best=scores[0], ranked=tuple(scores))


# ---------------------------------------------------------------------------
# Speculative decoding: whether, with which draft, and how deep
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpeculationDecision:
    """Outcome of pricing draft-model speculation against plain decode.

    Per-committed-token wall times at the given decode shape; ``use`` is
    True when the best (draft, k) candidate prices below plain decode.
    """
    use: bool
    draft: str
    k: int                       # best candidate depth (even when not used)
    acceptance: float            # the alpha the decision priced on
    plain_step_s: float          # plain decode, per token
    spec_step_s: float           # best speculative candidate, per token
    table: Tuple[Tuple[int, float], ...]   # (k, per-token s) per candidate

    @property
    def projected_speedup(self) -> float:
        return (self.plain_step_s / self.spec_step_s
                if self.spec_step_s > 0 else float("inf"))

    def summary(self) -> Dict:
        """JSON-safe decision record (trace / ServeReport)."""
        return {"use": self.use, "draft": self.draft, "k": self.k,
                "acceptance": self.acceptance,
                "plain_step_s": self.plain_step_s,
                "spec_step_s": self.spec_step_s,
                "projected_speedup": self.projected_speedup,
                "table": [[k, t] for k, t in self.table]}


def choose_speculation(target_cfg: ModelConfig, draft_cfg: ModelConfig, *,
                       kv_len: int, n_tokens: int, acceptance: float,
                       device_name: str = "nvidia-h100",
                       target_device=None, draft_device=None,
                       k_candidates: Sequence[int] = (1, 2, 3, 4),
                       draft_name: str = "draft") -> SpeculationDecision:
    """Price speculative decoding against plain decode and pick the depth.

    The paper's trade-off analysis applied to the decode hot path: one
    plain step commits ``n_tokens`` tokens (one per slot) in ``t_plain``;
    one speculative round spends k+1 draft steps plus a single
    (k+1)-position verify step on the target and commits
    ``E[c] * n_tokens`` tokens.  The verify step is priced as a target step
    carrying ``n_tokens * (k+1)`` tokens (batch scaling amortizes the
    weight reads the way the multi-position step does).  ``acceptance``
    comes from the profile cache
    (:func:`repro_torch.profiling.cached_acceptance`), a prior, or the
    acceptance tracker's online EWMA; ``target_device``/``draft_device``
    override the registry lookup (calibrated or drift-scaled models).
    """
    t_plain = step_time_model(target_cfg, kv_len, n_tokens,
                              device_name, device=target_device)
    t_draft = step_time_model(draft_cfg, kv_len, n_tokens,
                              device_name, device=draft_device)
    table = []
    for k in k_candidates:
        t_verify = step_time_model(target_cfg, kv_len,
                                   n_tokens * (k + 1),
                                   device_name, device=target_device)
        e = cost_model.expected_tokens_per_round(acceptance, k)
        per_tok = ((k + 1) * t_draft + t_verify) / (e * n_tokens)
        table.append((int(k), per_tok))
    best_k, best_t = min(table, key=lambda kt: kt[1])
    return SpeculationDecision(
        use=best_t < t_plain / n_tokens, draft=draft_name, k=best_k,
        acceptance=float(acceptance), plain_step_s=t_plain / n_tokens,
        spec_step_s=best_t, table=tuple(table))
