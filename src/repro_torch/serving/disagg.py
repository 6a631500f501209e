"""Phase-disaggregated serving: prefill and decode on separate engines.

CNNLab offloads each network stage to the accelerator where its trade-off
wins (§III.A/IV); serving has exactly two stages — compute-bound prefill
and memory-bound decode — so the same split applies: a *prefill engine*
ingests prompts, and at the phase boundary each request's per-slot state
(KV pages, feed position, first sampled token) is exported and imported
into a *decode engine* that carries the generation.  The hand-off is the
paper's offload overhead (PCIe sync, Fig. 5 step 4) applied to the phase
boundary: the loop meters the bytes it moves and prices them with
``core.cost_model.transfer_cost`` on the two phases' device models — the
model ``serving.placement`` uses to decide whether the split is worth it.
Under the paged KV layout (the default) only the pages holding the
prefilled tokens ship, so the hand-off bytes scale with the prompt.

The JAX package's ``serving/disagg.py``, on the port's slot engines: both
phase engines step through the same slot step, so on a card each replays
its own CUDA graph around the paged-attention kernel.  With a
:class:`~repro_torch.launch.mesh.DeviceAssignment` each engine lives on its
assigned device (with one card both share it, and its weights); without
one both live on ``device``.

The hand-off is **asynchronous and double-buffered**: the prefill side
exports the snapshot (fresh copies, queued behind its steps), and with an
assignment starts the copy toward the decode device on a side stream
(:func:`~repro_torch.serving.engine_loop.state_to_device`), releases its
slot and goes straight back to stepping; the decode side adopts the slot
once the copy has finished — at most :data:`MAX_PENDING_HANDOFFS` ride in
flight.  The :class:`HandoffLedger` meters both sides of the overlap:
``stall_s`` is the time adoption blocked on an unfinished copy,
``overlap_s`` the dispatch-to-adoption window the copy had to hide in.
``async_handoff=False`` adopts right after dispatch — the synchronous
baseline.

Each phase owns its own KV pool and :class:`ContinuousBatcher`, so
admission and migration are budgeted per (phase, engine) pair: queued
requests enter prefill against the prefill engine's budget; prefill-
complete requests migrate only when the decode engine's budget and pool
admit them (until then they hold their prefill slot — back-pressure on
admission).  Requests that could never fit the decode pool are shed before
they are admitted.

Per-request outputs equal the colocated
:class:`~repro_torch.serving.engine_loop.EngineLoop`'s: the migrated
snapshot is exact and the per-slot step math is engine-independent.

With a :class:`~repro_torch.serving.speculative.SpecPlan` the decode engine
speculates (a draft engine beside it proposes, the decode engine verifies
k+1 positions per round); prefill has no decode-phase slots.  Not here yet:
the watchdog's mid-run re-placement with live migration of decode slots
(ROADMAP §1 item 6c), which speculation would pin anyway; ``serve()``
refuses the watchdog, telemetry feedback and persisted curves on this loop
for that reason.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import device_models
from ..core.cost_model import transfer_cost
from ..launch.mesh import DeviceAssignment
from ..models import transformer as T
from ..obs import MetricsRegistry, Observability, default_clock
from .batcher import ContinuousBatcher
from .driver import (OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink,
                     burst_size, sample_pools)
from .engine_loop import (SlotEngine, check_prefix_sharing, snapshot_ready,
                          snapshot_wait, state_to_device, trace_admission,
                          trace_completion, trace_phase_flip,
                          wire_pool_events)
from .kv_pool import KVPool
from .request import Request, RequestState
from .speculative import SpecPlan, SpeculativeDecoder, spec_dispatch

# double-buffering bound: at most this many dispatched-but-unadopted
# hand-offs ride in flight before the next dispatch blocks on the oldest
MAX_PENDING_HANDOFFS = 2


class HandoffLedger:
    """What the phase boundary actually moved, plus its modeled price.

    A thin view over the metrics registry's ``handoff_*`` counters
    (``n_handoffs``, ``bytes_moved``, ``modeled_s``, ``modeled_energy_j``,
    ``stats()``), so the values live in the same registry snapshot as KV
    occupancy and queue depth.  ``stall_s`` sums the time adoptions
    blocked waiting on an unfinished copy, ``overlap_s`` the
    dispatch-to-adoption windows the copies had to hide in.
    ``n_live_migrations`` counts hand-offs of in-flight decode slots,
    which the watchdog's placement actuation makes (not ported yet: 0).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            registry = MetricsRegistry()  # standalone view (tests)
        self._n = registry.counter("handoff_n")
        self._bytes = registry.counter("handoff_bytes")
        self._modeled_s = registry.counter("handoff_modeled_s")
        self._energy_j = registry.counter("handoff_modeled_energy_j")
        self._stall_s = registry.counter("handoff_stall_s")
        self._overlap_s = registry.counter("handoff_overlap_s")
        self._live = registry.counter("handoff_live_migrations")

    def record(self, n_bytes: int, price, *, stall_s: float = 0.0,
               overlap_s: float = 0.0, live: bool = False) -> None:
        """Account one hand-off: metered bytes + its transfer-cost price,
        plus the measured stall/overlap split of the actual copy."""
        self._n.inc()
        self._bytes.inc(n_bytes)
        self._modeled_s.inc(price.t_transfer)
        self._energy_j.inc(price.energy_j)
        self._stall_s.inc(max(stall_s, 0.0))
        self._overlap_s.inc(max(overlap_s, 0.0))
        if live:
            self._live.inc()

    @property
    def n_handoffs(self) -> int:
        return int(self._n.value)

    @property
    def bytes_moved(self) -> int:
        return int(self._bytes.value)

    @property
    def modeled_s(self) -> float:
        return self._modeled_s.value

    @property
    def modeled_energy_j(self) -> float:
        return self._energy_j.value

    @property
    def stall_s(self) -> float:
        return self._stall_s.value

    @property
    def overlap_s(self) -> float:
        return self._overlap_s.value

    @property
    def n_live_migrations(self) -> int:
        return int(self._live.value)

    def stats(self) -> Dict[str, float]:
        return {
            "n_handoffs": self.n_handoffs,
            "bytes_moved": self.bytes_moved,
            "modeled_s": self.modeled_s,
            "modeled_energy_j": self.modeled_energy_j,
            "stall_s": self.stall_s,
            "overlap_s": self.overlap_s,
            "n_live_migrations": self.n_live_migrations,
        }


@dataclasses.dataclass
class _PendingHandoff:
    """One dispatched-but-unadopted phase hand-off: the snapshot's copy may
    still be running; the decode pool lease already exists (``req.slot``),
    the prefill slot is released."""

    req: Request
    state: Dict
    written: int                 # src-lease written tokens at export
    dst_written0: int            # dst-lease pre-adoption (shared) tokens
    skip_blocks: int             # prefix-shared leading pages, not landed
    steps_total: int             # decode steps the adopting engine owes
    t_dispatch: float            # tracer-clock stamp at dispatch
    span: Optional[object]       # open "handoff" tracer span


class DisaggregatedEngineLoop:
    """Two SlotEngines (prefill + decode) with explicit slot migration.

    The open-loop scaffolding lives in :class:`~repro_torch.serving.driver.
    OpenLoopDriver` (shared with the colocated loop); this class provides
    the two-engine hooks: admission binds the prefill phase only, the
    completion scan detects the phase boundary, and migration at admission
    passes carries slots onto the decode engine.  ``device`` defaults to
    the card (each engine's steps replay its own CUDA graph there unless
    ``cuda_graph=False``); ``assignment`` places each phase instead.
    ``plan`` runs speculative decoding on the decode engine.
    """

    def __init__(self, cfg: T.ModelConfig, params, *, n_prefill_slots: int,
                 n_decode_slots: int, max_seq: int, block_size: int = 16,
                 kv_layout: str = "paged",
                 prefill_total_blocks: Optional[int] = None,
                 decode_total_blocks: Optional[int] = None,
                 prefill_device_name: str = "nvidia-h100",
                 decode_device_name: str = "nvidia-h100",
                 prefill_device: Optional[device_models.DeviceModel] = None,
                 decode_device: Optional[device_models.DeviceModel] = None,
                 step_slo_s: Optional[float] = None,
                 handoff_link_bw: Optional[float] = None,
                 assignment: Optional[DeviceAssignment] = None,
                 async_handoff: bool = True,
                 prefix_sharing: bool = False,
                 plan: Optional[SpecPlan] = None,
                 propose_override: Optional[Callable] = None,
                 obs: Optional[Observability] = None,
                 device="cuda", cuda_graph: bool = True):
        if prefix_sharing:
            check_prefix_sharing(cfg, kv_layout)
        devices = ((assignment.prefill, assignment.decode)
                   if assignment is not None
                   else (torch.device(device),) * 2)
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            raise RuntimeError("DisaggregatedEngineLoop: no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        self.kv_layout = kv_layout
        self.prefix_sharing = prefix_sharing
        self.assignment = assignment
        self.obs = obs if obs is not None else Observability()
        # each phase pool runs its own prefix index: the prefill index
        # serves admission (prefill skipping), the decode index dedupes
        # migrated prompts so sharers land only their unique pages
        prefill_pool = KVPool(n_prefill_slots, max_seq, block_size=block_size,
                              total_blocks=prefill_total_blocks,
                              prefix_sharing=prefix_sharing)
        decode_pool = KVPool(n_decode_slots, max_seq, block_size=block_size,
                             total_blocks=decode_total_blocks,
                             prefix_sharing=prefix_sharing)
        self.prefill = SlotEngine(
            cfg, params, prefill_pool, kv_layout=kv_layout, name="prefill",
            device=devices[0], cuda_graph=cuda_graph)
        # the prefill engine's compute-dtype weights: on the same device
        # the decode engine shares them (its cast and move are no-ops)
        self.decode = SlotEngine(
            cfg, self.prefill.params, decode_pool, kv_layout=kv_layout,
            name="decode", device=devices[1], cuda_graph=cuda_graph)
        wire_pool_events(prefill_pool, self.obs.tracer)
        wire_pool_events(decode_pool, self.obs.tracer)
        self.prefill_batcher = ContinuousBatcher(
            cfg, prefill_pool, phase="prefill",
            device_name=prefill_device_name, device_model=prefill_device,
            step_slo_s=step_slo_s)
        self.decode_batcher = ContinuousBatcher(
            cfg, decode_pool, phase="decode",
            device_name=decode_device_name, device_model=decode_device,
            step_slo_s=step_slo_s)
        self._prefill_dev = (prefill_device
                             or device_models.get(prefill_device_name))
        self._decode_dev = (decode_device
                            or device_models.get(decode_device_name))
        self._handoff_link_bw = handoff_link_bw
        # speculative decoding rides the decode engine only (prefill has no
        # decode-phase slots); the draft's cache is pinned to that engine
        self.spec = (SpeculativeDecoder(self.decode, plan,
                                        propose_override=propose_override,
                                        target_params=params)
                     if plan is not None else None)
        self._async_handoff = async_handoff
        self.handoff = HandoffLedger(registry=self.obs.registry)
        # prefill-complete requests awaiting migration (reset per run)
        self._ready: List[Request] = []
        # dispatched hand-offs whose copy may still be running
        self._pending: List[_PendingHandoff] = []

    def warmup(self) -> None:
        self.prefill.warmup()
        self.decode.warmup()
        if self.spec is not None:
            self.spec.warmup()

    @property
    def batchers(self):
        return (self.prefill_batcher, self.decode_batcher)

    @property
    def n_active(self) -> int:
        """Slots bound across both phase engines (parked ready slots and
        in-flight hand-offs included)."""
        return (self.prefill.n_active + self.decode.n_active
                + len(self._pending))

    @property
    def decode_target(self) -> str:
        """Which hosted engine serves the decode phase: always "decode"
        until the watchdog's placement actuation is ported."""
        return "decode"

    def on_drift(self, alert, watchdog) -> None:
        raise NotImplementedError(
            "the watchdog's re-pricing and re-placement on the "
            "disaggregated loop: not ported yet; ROADMAP §1 item 6c "
            "(re-placement and live migration) ports it")

    # ---- migration -------------------------------------------------------
    def _dispatch_handoff(self, req: Request) -> bool:
        """Start moving a prefill-complete request onto the decode engine.
        Returns False (leaving the request parked in its prefill slot) when
        the decode engine's token budget or pool cannot take it yet.

        The dispatch half of the hand-off: export the snapshot, start its
        copy toward the decode device (with an assignment) and release the
        prefill slot.  Adoption happens in :meth:`_adopt` once the copy has
        finished (or right away without ``async_handoff``).  At most
        :data:`MAX_PENDING_HANDOFFS` dispatched copies ride in flight; past
        that the oldest is adopted first (blocking)."""
        if (self.decode.n_active + len(self._pending)
                >= self.decode_batcher.token_budget):
            return False
        prompt = req.prompt if self.decode.pool.prefix_sharing else None
        if not self.decode.pool.can_admit(req.total_tokens, prompt):
            return False
        while len(self._pending) >= MAX_PENDING_HANDOFFS:
            self._adopt(self._pending.pop(0))
        tracer = self.obs.tracer
        h = (tracer.begin("handoff", track="requests", tid=req.rid,
                          cat="request")
             if tracer.enabled else None)
        state = self.prefill.export_slot(req.slot)
        written = self.prefill.pool.lease(req.rid).written_tokens
        self.prefill.release(req)
        req.slot = self.decode.pool.alloc(req.rid, req.total_tokens,
                                          prompt=prompt)
        # prefix coherence at the hand-off: blocks the decode-side index
        # already serves are shared (refcounted) rather than re-imported,
        # and a dest-side COW tail takes its content from the snapshot page
        # itself, so the pending pool copy is consumed without a copy
        dst_lease = self.decode.pool.lease(req.rid)
        skip = dst_lease.shared_tokens // self.decode.pool.block_size
        self.decode.pool.consume_cow(req.rid)
        if self.assignment is not None:
            # the copy runs on a side stream while prefill keeps stepping
            state = state_to_device(state, self.decode.device)
        # the prefill engine already produced the first sample; the decode
        # engine owes the remaining gen - 1 steps
        self._pending.append(_PendingHandoff(
            req=req, state=state, written=written,
            dst_written0=dst_lease.written_tokens, skip_blocks=skip,
            steps_total=req.max_new_tokens - 1,
            t_dispatch=tracer.now(), span=h))
        if not self._async_handoff:
            self._adopt(self._pending.pop())
        return True

    def _adopt(self, ph: _PendingHandoff) -> None:
        """Adoption half of the hand-off: wait out whatever part of the
        copy is still running (the measured *stall*), install the snapshot
        into the decode slot and account the hand-off."""
        tracer = self.obs.tracer
        t0 = tracer.now()
        snapshot_wait(ph.state)
        stall = tracer.now() - t0
        # the window the copy had to hide in: dispatch -> adoption start
        overlap = max(t0 - ph.t_dispatch, 0.0)
        req = ph.req
        self.decode.adopt(req, ph.state, steps_total=ph.steps_total,
                          skip_blocks=ph.skip_blocks)
        if self.spec is not None:
            # fresh draft mirror for the adopted slot; the draft replays the
            # committed chain from the imported prompt and output buffers at
            # its first speculative round
            self.spec.reset_slot(req.slot)
        # carry the KV-write accounting into the decode pool's ledger
        # (the lease already counts its shared tokens as written)
        self.decode.pool.note_write(
            req.rid, min(ph.written, req.total_tokens) - ph.dst_written0)
        req.state = RequestState.DECODE
        self.decode_batcher.n_admitted += 1      # migration ledger
        n_bytes = SlotEngine.state_nbytes(ph.state)
        price = transfer_cost(n_bytes, self._prefill_dev, self._decode_dev,
                              link_bw=self._handoff_link_bw)
        self.handoff.record(n_bytes, price, stall_s=stall, overlap_s=overlap)
        if ph.span is not None:
            tracer.end(ph.span, args={"bytes": n_bytes,
                                      "modeled_s": price.t_transfer,
                                      "modeled_energy_j": price.energy_j,
                                      "stall_s": stall,
                                      "overlap_s": overlap,
                                      "async": self._async_handoff})

    def _drain_handoffs(self) -> None:
        """Adopt dispatched hand-offs, oldest first: every one whose copy
        has finished, plus (blocking) while the pipeline is over the
        double-buffer bound or the decode engine sits idle."""
        while self._pending:
            must = (len(self._pending) > MAX_PENDING_HANDOFFS
                    or self.decode.n_active == 0)
            if not must and not snapshot_ready(self._pending[0].state):
                break
            self._adopt(self._pending.pop(0))

    # ---- main loop -------------------------------------------------------
    def run(self, requests: List[Request], *,
            now_fn: Callable[[], float] = default_clock,
            max_steps: Optional[int] = None,
            on_delta: Optional[Callable[[StreamDelta], None]] = None
            ) -> ServeMetrics:
        """Serve `requests` via the shared open-loop driver.  ``on_delta``
        streams: the prefill engine emits each request's first sample at its
        phase boundary, the decode engine the rest."""
        return OpenLoopDriver(self).run(requests, now_fn=now_fn,
                                        max_steps=max_steps,
                                        on_delta=on_delta)

    # ---- OpenLoopDriver hooks --------------------------------------------
    def start_run(self) -> None:
        self._ready = []
        self._pending = []

    def in_flight(self) -> bool:
        return bool(self._ready or self._pending or self.prefill.n_active
                    or self.decode.n_active)

    def runnable(self) -> bool:
        return bool(self.prefill.n_active or self.decode.n_active)

    def backlogged(self, queue: List[Request]) -> bool:
        # bursts stay short while hand-offs or queued arrivals wait so
        # migration latency is bounded
        return bool(queue or self._ready or self._pending)

    def admit(self, queue: List[Request], now: float,
              metrics: ServeMetrics) -> None:
        # requests that can never fit the DECODE pool would park in a
        # prefill slot forever: shed them before admission
        i = 0
        while i < len(queue):
            r = queue[i]
            if (r.total_tokens > self.decode.pool.max_seq
                    or self.decode.pool.blocks_needed(r.total_tokens)
                    > self.decode.pool.total_blocks):
                r.state = RequestState.DROPPED
                metrics.drop()
                self.prefill_batcher.note_resolved(r.rid)
                if self.obs.tracer.enabled:
                    self.obs.tracer.instant(
                        "dropped", track="requests", tid=r.rid,
                        cat="request", args={"reason": "never-fits-decode"})
                queue.pop(i)
                continue
            i += 1

        # adopt finished in-flight hand-offs before dispatching new ones
        self._drain_handoffs()

        # migrate phase-boundary requests (decode budget + pool gated)
        self._ready = [req for req in self._ready
                       if not self._dispatch_handoff(req)]

        # admit new arrivals into the prefill engine; ready requests
        # still hold prefill slots, so n_active covers them
        decision = self.prefill_batcher.admit(
            queue, self.prefill.n_active, now)
        metrics.drop(len(decision.dropped))
        for req in decision.admitted:
            # the first sample lands after plen steps (minus any
            # prefix-shared tokens, skipped by binding at an offset); the
            # rest of the generation belongs to the decode engine
            shared = self.prefill.pool.shared_tokens(req.rid)
            req.shared_tokens = shared
            self.prefill.bind(req, start_pos=shared,
                              steps_total=req.prompt_len - shared)
        trace_admission(self.obs, self.prefill_batcher, decision,
                        self.prefill.n_active)

    def dispatch(self, throttle: bool, budget: Optional[int]) -> int:
        # one burst per engine per driver iteration; parked (phase-boundary)
        # prefill slots are active but not burstable
        tracer = self.obs.tracer
        n = 0
        for eng, batcher in ((self.prefill, self.prefill_batcher),
                             (self.decode, self.decode_batcher)):
            mask = eng.active & (eng.steps_done < eng.steps_total)
            if not mask.any():
                continue
            if (eng is self.decode and self.spec is not None
                    and self.spec.enabled):
                rem = eng.steps_total - eng.steps_done
                if (rem[mask] >= self.spec.plan.k).all():
                    # every burstable decode slot clears the page-lease
                    # gate: one speculative round instead of a plain burst
                    plens = np.array([0 if r is None else r.prompt_len
                                      for r in eng.slots], np.int64)
                    n += spec_dispatch(
                        self.spec, eng, eng.pool, batcher, self.obs,
                        mask=mask, pos=plens + eng.steps_done, rem=rem,
                        budget=None if budget is None else budget - n)
                    continue
            remaining = (eng.steps_total - eng.steps_done)[mask]
            burst = burst_size(
                int(remaining.min()), throttle=throttle,
                budget=None if budget is None else budget - n)
            if burst > 0:
                h = (tracer.begin("burst", track=f"engine:{eng.name}",
                                  cat="engine",
                                  args={"steps": burst,
                                        "n_active": int(mask.sum())})
                     if tracer.enabled else None)
                eng.dispatch(burst, mask)
                if h is not None:
                    tracer.end(h)
                n += burst
        return n

    def sample(self, metrics: ServeMetrics) -> None:
        # capacity-weighted across the two pools: occupancy by total_blocks,
        # utilization by allocated-block capacity
        occ, util = sample_pools((self.prefill.pool, self.decode.pool))
        metrics.occupancy.append(occ)
        metrics.utilization.append(util)

    def scan(self, clock: Callable[[], float], metrics: ServeMetrics,
             sink: TokenSink) -> None:
        now = clock()
        # prefill completions -> phase boundary
        ready_rids = {r.rid for r in self._ready}
        for s, req in enumerate(self.prefill.slots):
            if req is None or req.rid in ready_rids:
                continue
            req.n_fed = int(self.prefill.steps_done[s]) + req.shared_tokens
            if (req.state is not RequestState.DECODE
                    and self.prefill.steps_done[s]
                    >= self.prefill.steps_total[s]):
                # the burst containing the first sample has been dispatched
                req.state = RequestState.DECODE
                req.t_first_dispatch = now
                trace_phase_flip(self.obs.tracer, req, now)
                self._ready.append(req)
                ready_rids.add(req.rid)
        for s, req in enumerate(self.decode.slots):
            if req is not None:
                req.n_fed = req.prompt_len + int(self.decode.steps_done[s])
        # streaming: burst-boundary sync per engine — the prefill engine
        # emits first samples (including parked slots), the decode engine
        # the rest of each generation
        sink.drain(self.prefill, clock)
        sink.drain(self.decode, clock)
        # decode completions
        tracer = self.obs.tracer
        eng = self.decode
        for s, req in enumerate(eng.slots):
            if req is None or req.state is not RequestState.DECODE:
                continue
            if eng.steps_done[s] >= eng.steps_total[s]:
                h = (tracer.begin("sync", track=f"engine:{eng.name}",
                                  cat="engine",
                                  args={"kind": "completion"})
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
