"""Token-budgeted continuous batcher with engine-aware admission.

Every engine iteration processes one token per active slot, so the step's
token count == the number of active slots.  The batcher decides how many
slots may be active by pricing a decode step with ``core/cost_model.py`` on
the target device model (the port prices on ``H100``) — the same trade-off
machinery the layer scheduler uses to pick engines (CNNLab §III.A), applied
to traffic instead of layers: admission stops at the largest batch whose
modeled step time still meets the per-step latency objective (decode SLO),
and at the KV pool's free blocks.

Eviction is deadline shedding: queued requests whose deadline has passed are
DROPPED rather than admitted.

When the pool runs prefix sharing, admission prices a request's *fresh*
footprint: blocks the prefix index already serves are not drawn from the
free list.

Invariant: admission is pure *scheduling* policy.  Greedy per-request
outputs depend only on the prompt and the model, never on the admission
order or the token budget.

:meth:`ContinuousBatcher.reprice` installs another step-time function:
speculative decoding re-prices admission when it engages and again when its
acceptance veto turns it off, and the performance watchdog
(:class:`~repro_torch.obs.watchdog.PerfWatchdog`, through
``EngineLoop.on_drift``) re-prices through the same method.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core import device_models
from ..core.cost_model import layer_cost
from ..core.layer_model import (AttentionSpec, MLPSpec, MoESpec, NetworkSpec,
                                SSMSpec)
from ..models.transformer import ModelConfig
from .kv_pool import KVPool
from .request import Request, RequestState


def phase_network_spec(cfg: ModelConfig, *, seq: int,
                       kv_len: int) -> NetworkSpec:
    """Declarative layer-tuple spec for one serving-phase call of `cfg`:
    ``seq`` tokens attending over ``kv_len`` cached positions.  ``seq=1``
    is a decode step; ``seq=prompt_len, kv_len=prompt_len`` is prefill —
    the two workloads phase placement prices against each other."""
    layers = []
    for i, btype in enumerate(cfg.layer_types()):
        if btype in ("attn", "xattn"):
            layers.append(AttentionSpec(
                f"L{i}.attn", d_model=cfg.d_model, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, seq=seq, kv_len=kv_len,
                causal=True, window=cfg.attn_window, qkv_bias=cfg.qkv_bias,
                cross=btype == "xattn"))
        elif btype == "rec":
            layers.append(SSMSpec(f"L{i}.rglru", d_model=cfg.d_model,
                                  d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                                  expand=cfg.ssm_expand, seq=seq,
                                  variant="rglru"))
        elif btype == "mamba":
            layers.append(SSMSpec(f"L{i}.mamba", d_model=cfg.d_model,
                                  d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                                  expand=cfg.ssm_expand, seq=seq,
                                  variant="mamba1"))
        if btype != "mamba":            # mamba blocks have no separate MLP
            if cfg.n_experts > 0:
                layers.append(MoESpec(f"L{i}.moe", d_model=cfg.d_model,
                                      d_ff=cfg.d_ff, seq=seq,
                                      n_experts=cfg.n_experts,
                                      top_k=cfg.moe_top_k,
                                      gated=cfg.gated_mlp))
            else:
                layers.append(MLPSpec(f"L{i}.mlp", d_model=cfg.d_model,
                                      d_ff=cfg.d_ff, seq=seq,
                                      gated=cfg.gated_mlp))
    tag = "decode-step" if seq == 1 else f"prefill{seq}"
    return NetworkSpec(f"{cfg.name}-{tag}", tuple(layers))


def decode_network_spec(cfg: ModelConfig, kv_len: int) -> NetworkSpec:
    """Per-token decode-step spec — what admission prices (one engine
    iteration carries one token per active slot)."""
    return phase_network_spec(cfg, seq=1, kv_len=kv_len)


def step_time_model(cfg: ModelConfig, kv_len: int, n_tokens: int,
                    device_name: str = "nvidia-h100",
                    dtype_bytes: int = 2,
                    device: Optional[device_models.DeviceModel] = None
                    ) -> float:
    """Modeled wall time of one engine step carrying `n_tokens` tokens.

    ``device`` overrides the registry lookup — this is how admission prices
    on a profiling-calibrated model (``repro.profiling.calibrate``) instead
    of the nominal constants."""
    if device is None:
        device = device_models.get(device_name)
    net = decode_network_spec(cfg, kv_len)
    return sum(layer_cost(l, device, batch=n_tokens,
                          dtype_bytes=dtype_bytes).t_total for l in net)


def token_budget_for_slo(cfg: ModelConfig, kv_len: int, n_slots: int,
                         step_slo_s: float,
                         device_name: str = "nvidia-h100",
                         device: Optional[device_models.DeviceModel] = None
                         ) -> int:
    """Largest per-step token count whose modeled step time meets the SLO
    (always >= 1: a budget that admits nothing serves nothing)."""
    budget = 1
    for k in range(2, n_slots + 1):
        if step_time_model(cfg, kv_len, k, device_name,
                           device=device) > step_slo_s:
            break
        budget = k
    return budget


@dataclasses.dataclass
class AdmissionDecision:
    admitted: List[Request]
    dropped: List[Request]


class ContinuousBatcher:
    """Admits QUEUED requests into pool slots against the token budget.

    One batcher governs one (phase, engine) pair: its token budget is
    priced on *its* device model, so a disaggregated deployment runs two —
    a prefill batcher budgeted on the prefill engine and a decode batcher
    budgeted on the decode engine (``phase`` labels which this is)."""

    def __init__(self, cfg: ModelConfig, pool: KVPool, *,
                 device_name: str = "nvidia-h100",
                 device_model: Optional[device_models.DeviceModel] = None,
                 step_slo_s: Optional[float] = None,
                 token_budget: Optional[int] = None,
                 phase: str = "decode"):
        self.cfg = cfg
        self.pool = pool
        self.phase = phase
        self.device_name = (device_model.name if device_model is not None
                            else device_name)
        self.device_model = device_model
        # kept so a mid-run re-price can refit the token budget against the
        # same objective admission was originally sized for
        self.step_slo_s = step_slo_s
        # installed by reprice(): a step-time function that replaces the
        # analytic pricing
        self._price_override = None
        self._price_source = "analytic"
        self.n_reprices = 0
        if token_budget is None:
            if step_slo_s is None:
                token_budget = pool.n_slots
            else:
                token_budget = token_budget_for_slo(
                    cfg, pool.max_seq, pool.n_slots, step_slo_s, device_name,
                    device=device_model)
        if token_budget <= 0:
            raise ValueError("token_budget must be >= 1 (a budget that "
                             "admits nothing serves nothing)")
        self.token_budget = min(token_budget, pool.n_slots)
        # cumulative admission accounting
        self.n_admitted = 0
        self.n_rejected = 0              # dropped: deadline passed / never fits
        # rids currently deferred and not yet admitted/dropped.  Bounded by
        # the live queue length: a rid is discarded the moment its request
        # resolves, so a long-lived stream doesn't leak a set entry per
        # request.  The ever-deferred total lives in the monotone counter.
        self._deferred_rids: set = set()
        self._n_deferred_total = 0

    @property
    def price_source(self) -> str:
        """Where the current pricing came from: ``analytic`` until
        :meth:`reprice` installs another source (``speculation`` when
        speculation engages, ``speculation-disabled`` after its veto)."""
        return self._price_source

    @property
    def n_deferred(self) -> int:
        """Distinct requests ever left queued by an admit pass (budget or
        pool pressure) — comparable to the admitted/rejected counts.
        Monotone counter; re-deferrals of a still-queued request count
        once."""
        return self._n_deferred_total

    def note_resolved(self, rid: int) -> None:
        """Forget a deferred request resolved outside :meth:`admit` (the
        disaggregated loop sheds requests that never fit its decode pool)."""
        self._deferred_rids.discard(rid)

    def priced_step_s(self, n_tokens: int) -> float:
        """This batcher's modeled per-step wall time at ``n_tokens`` tokens
        per step — the cost its token budget prices admission against, on
        its own device model.  The tracer stamps it into admission spans so
        traces carry priced-vs-observed cost side by side.  After
        :meth:`reprice` this is the installed step-time function instead of
        the analytic model."""
        if self._price_override is not None:
            return self._price_override(max(int(n_tokens), 1))
        return self.analytic_step_s(n_tokens)

    def analytic_step_s(self, n_tokens: int) -> float:
        """The pure analytic price, ignoring any installed override."""
        return step_time_model(self.cfg, self.pool.max_seq,
                               max(int(n_tokens), 1), self.device_name,
                               device=self.device_model)

    def reprice(self, step_time_fn, *, source: str = "telemetry") -> dict:
        """Install ``step_time_fn`` (tokens -> seconds) as this batcher's
        pricing and refit the token budget against the stored step SLO, so
        later admission (and the ``priced_step_s`` stamped into traces)
        prices on it.  Returns a JSON-safe event describing the change."""
        old_budget = self.token_budget
        self._price_override = step_time_fn
        self._price_source = source
        if self.step_slo_s is not None:
            budget = 1
            for k in range(2, self.pool.n_slots + 1):
                if step_time_fn(k) > self.step_slo_s:
                    break
                budget = k
            self.token_budget = min(budget, self.pool.n_slots)
        self.n_reprices += 1
        return {"pricing": source,
                "token_budget_old": int(old_budget),
                "token_budget": int(self.token_budget),
                "step_slo_s": self.step_slo_s,
                "priced_step_s_at_budget":
                    float(self.priced_step_s(self.token_budget))}

    def admit(self, queue: List[Request], n_active: int,
              now: float) -> AdmissionDecision:
        """Pop admissible requests from `queue` (mutated in place).

        Priority order: (priority, arrival).  A request that does not fit
        the pool right now blocks lower-priority requests behind it only if
        they would also not fit (no starvation of big requests, but small
        ones may backfill free blocks).
        """
        admitted: List[Request] = []
        dropped: List[Request] = []
        queue.sort(key=lambda r: (r.priority, r.arrival, r.rid))
        i = 0
        while i < len(queue):
            req = queue[i]
            never_fits = (req.total_tokens > self.pool.max_seq
                          or self.pool.blocks_needed(req.total_tokens)
                          > self.pool.total_blocks)
            if never_fits or (req.deadline is not None and now > req.deadline):
                req.state = RequestState.DROPPED
                dropped.append(queue.pop(i))
                continue
            if n_active + len(admitted) >= self.token_budget:
                break
            # prefix sharing makes admission cheaper: only the blocks the
            # prefix index cannot serve are drawn from the free list, so a
            # mostly-shared request fits where a dense one would defer
            prompt = req.prompt if self.pool.prefix_sharing else None
            if not self.pool.can_admit(req.total_tokens, prompt):
                i += 1                   # try to backfill a smaller request
                continue
            req.slot = self.pool.alloc(req.rid, req.total_tokens,
                                       prompt=prompt)
            req.state = RequestState.PREFILL
            req.t_admitted = now
            admitted.append(queue.pop(i))
        self.n_admitted += len(admitted)
        self.n_rejected += len(dropped)
        for r in admitted:
            self._deferred_rids.discard(r.rid)
        for r in dropped:
            self._deferred_rids.discard(r.rid)
        for r in queue:
            if r.rid not in self._deferred_rids:
                self._deferred_rids.add(r.rid)
                self._n_deferred_total += 1
        return AdmissionDecision(admitted=admitted, dropped=dropped)
