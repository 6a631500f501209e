"""Continuous-batching engine loop on the block-paged KV cache.

One step (`decode_step_slots_paged`) advances every active slot by one token
per iteration — prefilling slots consume their next prompt token, decoding
slots consume their previously sampled token — so prefill interleaves with
the running decode batch, and a finished request's slot is refilled at the
next completion boundary.

Token feeding is device-resident: the fused step selects each slot's next
token from an uploaded prompt buffer (while ``pos < prompt_len``) or from the
previous argmax, and scatters sampled tokens into a per-slot output buffer.
The host never syncs per step: completion is deterministic in step count
(greedy decoding, known lengths), so the loop dispatches a *burst* of steps
up to the next completion boundary and only then pulls the finished slots'
rows.  The JAX package scans a burst inside one jitted call; here a burst is
a plain loop of eager steps whose kernels queue on the card's stream (CUDA
graphs are later work).

:class:`SlotEngine` holds the slot state and the burst machinery;
:class:`EngineLoop` composes one SlotEngine with a pool and a batcher and
provides the hooks :class:`~repro_torch.serving.driver.OpenLoopDriver`
calls.  The loop is driven by a clock function so tests can run it
reproducibly.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import transformer as T
from ..obs import Observability, default_clock
from .batcher import ContinuousBatcher
from .driver import (OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink,
                     burst_size, sample_pools)
from .kv_pool import KVPool
from .request import Request, RequestState

__all__ = ["EngineLoop", "ServeMetrics", "SlotEngine", "StreamDelta",
           "TokenSink"]


# ---- trace instrumentation -------------------------------------------------

def wire_pool_events(pool: KVPool, tracer) -> None:
    """Surface the pool's block-lease events as per-request trace instants
    (``kv_alloc``/``kv_free`` on the request's own tid)."""
    if not tracer.enabled:
        return

    def on_event(kind, rid, n_blocks):
        tracer.instant("kv_" + kind, track="requests", tid=rid, cat="kv",
                       args={"blocks": n_blocks})

    pool.on_event = on_event


def trace_admission(obs, batcher, decision, n_active: int) -> None:
    """Close each admitted request's ``queued`` span (arrival -> admission)
    with the priced cost the batcher admitted it against, and mark drops."""
    tracer = obs.tracer
    if not tracer.enabled:
        return
    if decision.admitted:
        priced = batcher.priced_step_s(n_active)
        for req in decision.admitted:
            req.priced_step_s = priced
            tracer.span("queued", req.arrival, req.t_admitted,
                        track="requests", tid=req.rid, cat="request",
                        args={"priced_step_s": priced,
                              "token_budget": batcher.token_budget,
                              "phase": batcher.phase,
                              "blocks": batcher.pool.blocks_needed(
                                  req.total_tokens),
                              "shared_tokens": req.shared_tokens})
    for req in decision.dropped:
        tracer.instant("dropped", track="requests", tid=req.rid,
                       cat="request",
                       args={"reason": "deadline-or-never-fits"})


def trace_phase_flip(tracer, req, now: float) -> None:
    """Prefill span: admission -> the first decode burst's dispatch."""
    if tracer.enabled:
        tracer.span("prefill", req.t_admitted, now, track="requests",
                    tid=req.rid, cat="request",
                    args={"prompt_len": req.prompt_len})


def trace_completion(tracer, req) -> None:
    """Decode span (dispatch -> done, priced vs observed per-step cost) +
    the ``done`` instant."""
    if not tracer.enabled:
        return
    if req.t_first_dispatch is not None and req.t_done is not None:
        dur = req.t_done - req.t_first_dispatch
        steps = max(req.max_new_tokens - 1, 1)
        tracer.span("decode", req.t_first_dispatch, req.t_done,
                    track="requests", tid=req.rid, cat="request",
                    args={"priced_step_s": req.priced_step_s,
                          "observed_step_s": dur / steps,
                          "tokens": len(req.output)})
    tracer.instant("done", track="requests", tid=req.rid, cat="request",
                   t=req.t_done,
                   args={"latency_s": (None if req.t_done is None
                                       else req.t_done - req.arrival)})


class SlotEngine:
    """Device-resident slot state + the burst machinery for one engine.

    Owns the paged slot cache, the prompt/output buffers and the per-slot
    step schedule.  Params are cast to the compute dtype once, on
    ``device``, and every buffer lives there.

    Invariants: the pool's lease order IS the block table — :meth:`bind`
    uploads ``KVPool.block_table`` verbatim.  The engine writes KV only at
    each slot's current position, so pages behind ``pos`` are immutable
    (what makes published prefix pages safe to share), and pending COW
    copies are materialized in :meth:`bind` before the slot's first write.
    :meth:`dispatch` reads the caller's ``active`` mask once, copying it to
    the device before it returns, so the caller may change its array right
    after; :meth:`sync` is a pure wait.
    """

    def __init__(self, cfg: T.ModelConfig, params, pool: KVPool, *,
                 name: str = "engine", device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = T.compute_params(
            T.map_params(lambda _, t: t.to(self.device), params), cfg)
        self.pool = pool
        self.name = name                 # labels this engine's trace track
        n_slots = pool.n_slots
        self.cache = T.init_slot_cache_paged(
            cfg, n_slots, pool.max_seq, block_size=pool.block_size,
            total_blocks=pool.total_blocks, device=self.device)
        self.max_prompt = pool.max_seq
        self.max_gen = pool.max_seq

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        self._prompts = zeros(n_slots, self.max_prompt)
        self._plens = zeros(n_slots)
        self._last_tok = zeros(n_slots)
        self._out_buf = zeros(n_slots, self.max_gen)
        self.slots: List[Optional[Request]] = [None] * n_slots
        # host-side schedule state: active steps done / total per slot, plus
        # the dispatch mask (bind sets, release clears)
        self.steps_done = np.zeros((n_slots,), np.int64)
        self.steps_total = np.zeros((n_slots,), np.int64)
        self.active = np.zeros((n_slots,), bool)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one physical KV page (every layer's K
        and V arena) so a writer diverging inside a shared tail page gets a
        private copy before its first write."""
        for layer in self.cache["layers"]:
            layer["k"][dst] = layer["k"][src]
            layer["v"][dst] = layer["v"][src]

    def bind(self, req: Request, *, steps_total: int,
             start_pos: int = 0) -> None:
        """Upload the request's prompt into its slot, materialize pending
        COW copies, upload its block table and reset its position.
        ``steps_total`` is the number of engine steps the request runs
        (plen + gen - 1, minus any prefix-shared tokens).  ``start_pos`` > 0
        binds at an offset (prefix sharing): positions ``[0, start_pos)``
        are served by shared pages, so the first fed token is
        ``prompt[start_pos]``."""
        s = req.slot
        row = torch.zeros((self.max_prompt,), dtype=torch.int32)
        row[:req.prompt_len] = torch.from_numpy(
            np.asarray(req.prompt, np.int32))
        self._prompts[s] = row.to(self.device)
        self._plens[s] = req.prompt_len
        for src, dst in self.pool.consume_cow(req.rid):
            self.copy_page(src, dst)
        table = self.pool.block_table(
            req.rid, pad_to=self.cache["block_tables"].shape[1])
        self.cache["block_tables"][s] = torch.from_numpy(table).to(
            self.device)
        T.reset_slot_state(self.cfg, self.cache, s)
        self.cache["pos"][s] = start_pos
        self.slots[s] = req
        self.steps_done[s] = 0
        self.steps_total[s] = steps_total
        self.active[s] = True

    def _step(self, active: torch.Tensor) -> None:
        """Device-side feed + step + sample + output scatter."""
        cache = self.cache
        b = self._prompts.shape[0]
        rows = torch.arange(b, device=self.device)
        pos = cache["pos"]
        prompt_tok = self._prompts[
            rows, torch.clamp(pos, max=self.max_prompt - 1).long()]
        tok = torch.where(pos < self._plens, prompt_tok, self._last_tok)
        logits, self.cache = T.decode_step_slots_paged(
            self.params, self.cfg, cache, tok[:, None], active,
            max_seq=self.pool.max_seq)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        # the sample is output index (pos - plen + 1); valid once the final
        # prompt token has been fed
        idx = pos - self._plens + 1
        write = active & (idx >= 0) & (idx < self.max_gen)
        safe = torch.clamp(idx, 0, self.max_gen - 1).long()
        self._out_buf[rows, safe] = torch.where(
            write, nxt, self._out_buf[rows, safe])
        self._last_tok = torch.where(active, nxt, self._last_tok)

    def dispatch(self, burst: int, active_np: np.ndarray) -> None:
        """Queue ``burst`` steps over the slots ``active_np`` marks, without
        a host sync.  The mask is copied to the device here, so changing
        ``active_np`` after this returns cannot reach the queued steps."""
        active = torch.tensor(active_np, dtype=torch.bool, device=self.device)
        with torch.no_grad():
            for _ in range(burst):
                self._step(active)
        self.steps_done[active_np] += burst
        for s, req in enumerate(self.slots):
            if req is not None and active_np[s]:
                self.pool.note_write(req.rid, burst)

    def sync(self) -> None:
        """Block until every queued step has run.  Waits only, so outputs
        are the same with or without it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pull_output(self, slot: int) -> np.ndarray:
        """Sync and read one slot's sampled-token row."""
        return self._out_buf[slot].cpu().numpy()

    def pull_outputs(self) -> np.ndarray:
        """Sync and read the whole (n_slots, max_gen) output buffer — one
        host sync per burst boundary, shared by every streaming slot."""
        return self._out_buf.cpu().numpy()

    def release(self, req: Request) -> None:
        """Free the request's slot + pool lease on this engine."""
        self.pool.free(req.rid)
        self.slots[req.slot] = None
        self.active[req.slot] = False


class EngineLoop:
    """Colocated serving: one SlotEngine runs both phases of every request.

    The open-loop scaffolding lives in :class:`~repro_torch.serving.driver.
    OpenLoopDriver`; this class provides the hook implementations
    (admission binds the request onto the engine, completion pulls the
    whole output row).  ``device`` defaults to the card.
    """

    def __init__(self, cfg: T.ModelConfig, params, *, n_slots: int,
                 max_seq: int, block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 device_name: str = "nvidia-h100",
                 device_model=None,
                 step_slo_s: Optional[float] = None,
                 token_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 obs: Optional[Observability] = None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EngineLoop: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.prefix_sharing = prefix_sharing
        self.obs = obs if obs is not None else Observability()
        self.pool = KVPool(n_slots, max_seq, block_size=block_size,
                           total_blocks=total_blocks,
                           prefix_sharing=prefix_sharing)
        self.batcher = ContinuousBatcher(
            cfg, self.pool, device_name=device_name,
            device_model=device_model, step_slo_s=step_slo_s,
            token_budget=token_budget)
        self.engine = SlotEngine(cfg, params, self.pool, name="colocated",
                                 device=device)
        wire_pool_events(self.pool, self.obs.tracer)

    @property
    def n_active(self) -> int:
        return self.engine.n_active

    @property
    def batchers(self):
        return (self.batcher,)

    def run(self, requests: List[Request], *,
            now_fn: Callable[[], float] = default_clock,
            max_steps: Optional[int] = None,
            on_delta: Optional[Callable[[StreamDelta], None]] = None
            ) -> ServeMetrics:
        """Serve `requests` (an arrival-stamped open-loop stream) to
        completion via the open-loop driver.  Returns the aggregate
        metrics; ``on_delta`` streams newly readable tokens at burst
        boundaries."""
        return OpenLoopDriver(self).run(requests, now_fn=now_fn,
                                        max_steps=max_steps,
                                        on_delta=on_delta)

    # ---- OpenLoopDriver hooks --------------------------------------------
    def start_run(self) -> None:
        pass                             # all per-run state lives on engines

    def in_flight(self) -> bool:
        return self.engine.n_active > 0

    def runnable(self) -> bool:
        return self.engine.n_active > 0

    def backlogged(self, queue: List[Request]) -> bool:
        return False                     # only pending arrivals throttle

    def admit(self, queue: List[Request], now: float,
              metrics: ServeMetrics) -> None:
        decision = self.batcher.admit(queue, self.engine.n_active, now)
        metrics.drop(len(decision.dropped))
        for req in decision.admitted:
            # greedy decoding with known lengths: the final sample lands
            # after plen + gen - 1 active steps, minus the prefix-shared
            # tokens, whose prefill is skipped by binding at an offset
            shared = self.pool.shared_tokens(req.rid)
            req.shared_tokens = shared
            self.engine.bind(
                req, start_pos=shared,
                steps_total=(req.prompt_len - shared
                             + req.max_new_tokens - 1))
        trace_admission(self.obs, self.batcher, decision,
                        self.engine.n_active)

    def dispatch(self, throttle: bool, budget: Optional[int]) -> int:
        # burst: dispatch steps to the next completion boundary without
        # any host sync; the card runs behind the dispatch
        eng = self.engine
        remaining = eng.steps_total - eng.steps_done
        burst = burst_size(int(remaining[eng.active].min()),
                           throttle=throttle, budget=budget)
        if burst <= 0:
            return 0
        tracer = self.obs.tracer
        h = (tracer.begin("burst", track=f"engine:{eng.name}", cat="engine",
                          args={"steps": burst, "n_active": eng.n_active})
             if tracer.enabled else None)
        eng.dispatch(burst, eng.active)
        if h is not None:
            tracer.end(h)
        return burst

    def sample(self, metrics: ServeMetrics) -> None:
        occ, util = sample_pools((self.pool,))
        metrics.occupancy.append(occ)
        metrics.utilization.append(util)

    def scan(self, clock: Callable[[], float], metrics: ServeMetrics,
             sink: TokenSink) -> None:
        eng = self.engine
        tracer = self.obs.tracer
        now = clock()
        for s, req in enumerate(eng.slots):
            if req is None:
                continue
            # shared-prefix tokens count as fed: the KV exists and the
            # feed pointer started past them
            req.n_fed = int(eng.steps_done[s]) + req.shared_tokens
            if (req.state is RequestState.PREFILL
                    and req.n_fed >= req.prompt_len):
                # the burst containing the first sample has been dispatched
                # (host-visible stamping happens in the sink)
                req.state = RequestState.DECODE
                req.t_first_dispatch = now
                trace_phase_flip(tracer, req, now)
        sink.drain(eng, clock)           # streaming: burst-boundary sync
        for s, req in enumerate(eng.slots):
            if req is None:
                continue
            if eng.steps_done[s] >= eng.steps_total[s]:
                # completion boundary: sync and pull this slot's tokens
                h = (tracer.begin("sync", track=f"engine:{eng.name}",
                                  cat="engine", args={"kind": "completion"})
                     if tracer.enabled else None)
                row = eng.pull_output(s)
                if h is not None:
                    tracer.end(h)
                req.state = RequestState.DONE
                req.t_done = clock()
                sink.finish(req, row[:req.max_new_tokens], req.t_done)
                eng.release(req)
                metrics.observe(req)
                trace_completion(tracer, req)
