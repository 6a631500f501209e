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

The watchdog's placement advice can also **actuate** here: when the two
phases price on distinct placement engines, a drift alert re-runs
``place_phases`` with the drifted device de-rated, and if the fresh decision
moves the decode phase onto the *other* hosted engine the loop switches its
decode target mid-run.  In-flight decode slots then live-migrate through the
same export/adopt machinery (as far as the destination's budget and pool
allow; the rest finish where they are), and later phase boundaries flip in
place instead of handing off.  A migrated slot lands in the destination's
buffers in place, so on a card that engine's captured graph steps it.  All
of it is scheduling: the per-slot step math is engine-independent, so the
tokens do not change.

With a :class:`~repro_torch.serving.speculative.SpecPlan` the decode engine
speculates (a draft engine beside it proposes, the decode engine verifies
k+1 positions per round); prefill has no decode-phase slots.  The draft's
cache is pinned to the decode engine, so while speculating the placement
decision stays advice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import device_models
from ..core.cost_model import transfer_cost
from ..core.engines import ENGINES_BY_NAME, TORCH_ENGINE
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
from .placement import drift_scaled_device, place_phases
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
    ``n_live_migrations`` counts hand-offs of in-flight decode slots
    between engines (the watchdog's placement actuation) rather than at a
    phase boundary.
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
    ``plan`` runs speculative decoding on the decode engine.  The
    placement engine names say which engines of
    :data:`~repro_torch.core.engines.ENGINES_BY_NAME` the two phases run
    as: with the same name for both, the watchdog's re-placement stays
    advice; with distinct ones it actuates (:meth:`_actuate_placement`).
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
                 prefill_placement_engine_name: str = TORCH_ENGINE.name,
                 decode_placement_engine_name: str = TORCH_ENGINE.name,
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
        # the placement engines the two slot engines run as; the watchdog's
        # mid-run re-placement de-rates the drifted phase's.  With one
        # shared name the decision stays advice, with distinct names it
        # actuates (_actuate_placement)
        self._prefill_placement_name = prefill_placement_engine_name
        self._decode_placement_name = decode_placement_engine_name
        self._async_handoff = async_handoff
        # which hosted engine serves the decode phase now: "decode" (hand-off
        # at the boundary) or "prefill" (flip in place); placement actuation
        # switches it mid-run
        self._decode_target = "decode"
        self.handoff = HandoffLedger(registry=self.obs.registry)
        # prefill-complete requests awaiting migration (reset per run)
        self._ready: List[Request] = []
        # dispatched hand-offs whose copy may still be running
        self._pending: List[_PendingHandoff] = []
        # rid -> n_fed at a live migration's export: steps_done restarts at 0
        # on the adopting engine, so fed accounting resumes from this base
        self._fed_base: Dict[int, int] = {}

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
        """Which hosted engine serves the decode phase now."""
        return self._decode_target

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

    def _drain_handoffs(self, *, force_all: bool = False) -> None:
        """Adopt dispatched hand-offs, oldest first: every one whose copy
        has finished, plus (blocking) while the pipeline is over the
        double-buffer bound, the decode engine sits idle, or the caller
        forces a full drain."""
        while self._pending:
            must = (force_all or len(self._pending) > MAX_PENDING_HANDOFFS
                    or self.decode.n_active == 0)
            if not must and not snapshot_ready(self._pending[0].state):
                break
            self._adopt(self._pending.pop(0))

    def _live_migrate(self, target: str) -> int:
        """Move in-flight DECODE slots onto the ``target`` engine through
        the export/adopt machinery of the phase boundary, synchronously, so
        each request resumes at once.  Slots the destination cannot take
        (budget or pool) finish where they are.  Returns the number of
        slots moved."""
        src = self.decode if target == "prefill" else self.prefill
        dst = self.prefill if target == "prefill" else self.decode
        dst_batcher = (self.prefill_batcher if target == "prefill"
                       else self.decode_batcher)
        src_dev = (self._decode_dev if target == "prefill"
                   else self._prefill_dev)
        dst_dev = (self._prefill_dev if target == "prefill"
                   else self._decode_dev)
        skip_rids = ({r.rid for r in self._ready}
                     | {ph.req.rid for ph in self._pending})
        tracer = self.obs.tracer
        moved = 0
        for s, req in enumerate(list(src.slots)):
            if (req is None or req.state is not RequestState.DECODE
                    or req.rid in skip_rids):
                continue
            remaining = int(src.steps_total[s] - src.steps_done[s])
            if remaining <= 0:
                continue                 # completes where it is
            if dst.n_active >= dst_batcher.token_budget:
                continue                 # budget-limited: finish in place
            prompt = req.prompt if dst.pool.prefix_sharing else None
            if not dst.pool.can_admit(req.total_tokens, prompt):
                continue                 # pool-limited: finish in place
            h = (tracer.begin("handoff", track="requests", tid=req.rid,
                              cat="request")
                 if tracer.enabled else None)
            # fed accounting resumes from the steps already run here
            base = self._fed_base.get(req.rid)
            if src is self.decode:
                fed_base = ((req.prompt_len if base is None else base)
                            + int(src.steps_done[s]))
            else:
                fed_base = ((req.shared_tokens if base is None else base)
                            + int(src.steps_done[s]))
            state = src.export_slot(s)
            written = src.pool.lease(req.rid).written_tokens
            src.release(req)
            req.slot = dst.pool.alloc(req.rid, req.total_tokens,
                                      prompt=prompt)
            dst_lease = dst.pool.lease(req.rid)
            skip = dst_lease.shared_tokens // dst.pool.block_size
            dst.pool.consume_cow(req.rid)
            if self.assignment is not None:
                state = state_to_device(state, dst.device)
            t0 = tracer.now()
            snapshot_wait(state)
            stall = tracer.now() - t0
            dst.adopt(req, state, steps_total=remaining, skip_blocks=skip)
            dst.pool.note_write(
                req.rid,
                min(written, req.total_tokens) - dst_lease.written_tokens)
            self._fed_base[req.rid] = fed_base
            n_bytes = SlotEngine.state_nbytes(state)
            price = transfer_cost(n_bytes, src_dev, dst_dev,
                                  link_bw=self._handoff_link_bw)
            self.handoff.record(n_bytes, price, stall_s=stall, live=True)
            moved += 1
            if h is not None:
                tracer.end(h, args={"bytes": n_bytes,
                                    "modeled_s": price.t_transfer,
                                    "kind": "live-migration",
                                    "from": src.name, "to": dst.name,
                                    "remaining_steps": remaining,
                                    "stall_s": stall})
        return moved

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
        self._fed_base = {}

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

        # migrate phase-boundary requests (decode budget + pool gated), or,
        # when placement actuation moved the decode phase onto the prefill
        # engine, resume them in place (colocated step math)
        if self._decode_target == "prefill":
            for req in self._ready:
                self.prefill.steps_total[req.slot] += req.max_new_tokens - 1
            self._ready = []
        else:
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
        tracer, fb, wd = self.obs.tracer, self.obs.feedback, self.obs.watchdog
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
                n_burst = int(mask.sum())
                h = (tracer.begin("burst", track=f"engine:{eng.name}",
                                  cat="engine",
                                  args={"steps": burst, "n_active": n_burst})
                     if tracer.enabled else None)
                # only decode-engine bursts feed the telemetry: they run the
                # per-token decode step admission prices (a prefill burst
                # attributed to the decode batch size would double-count).
                # The watchdog watches both phases, each stream priced by
                # its own batcher
                feed = fb is not None and eng is self.decode
                timed = feed or wd is not None
                t0 = tracer.now() if timed else 0.0
                eng.dispatch(burst, mask)
                if timed:
                    # a pure wait: outputs stay bit-identical
                    eng.sync()
                    dt = tracer.now() - t0
                    if feed:
                        fb.observe_burst(n_burst, burst, dt)
                    if wd is not None:
                        wd.observe_burst(
                            eng.name, batcher.phase, n_tokens=n_burst,
                            steps=burst, elapsed_s=dt,
                            priced_step_s=batcher.priced_step_s(n_burst))
                if h is not None:
                    tracer.end(h, args={"synced": timed})
                n += burst
        return n

    def on_drift(self, alert, watchdog) -> None:
        """Watchdog action leg, disaggregated: re-price the drifted phase's
        admission and re-run the placement DSE with that phase's device
        de-rated by the observed divergence.

        When both phases price on one placement engine the fresh
        :func:`~repro_torch.serving.placement.place_phases` decision is
        recorded as *advice* (the ``reprice`` event's detail); with distinct
        per-phase engine names it actuates: if it moves the decode phase
        onto the other hosted engine, the loop switches its decode target
        and live-migrates in-flight slots (:meth:`_live_migrate`).
        """
        batcher = {"prefill": self.prefill_batcher,
                   "decode": self.decode_batcher}.get(alert.phase)
        if batcher is None:
            return
        fn, source = watchdog.step_time_fn(
            alert.engine, alert.phase, batcher.analytic_step_s)
        if source == "analytic":
            return                       # nothing observed: keep the model
        detail = batcher.reprice(fn, source=source)
        detail.update(self._replace_placement(alert))
        watchdog.note_reprice(alert, detail)

    def _replace_placement(self, alert) -> Dict:
        """Re-run ``place_phases`` with the drifted device de-rated by the
        observed ratio; returns JSON-safe advice for the re-price event
        (plus what, if anything, was actuated)."""
        prefill = alert.phase == "prefill"
        name = (self._prefill_placement_name if prefill
                else self._decode_placement_name)
        dev = self._prefill_dev if prefill else self._decode_dev
        try:
            scaled = drift_scaled_device(dev, alert.ewma_ratio)
            # both hosted engines enter the DSE on their actual device
            # models, the drifted one de-rated
            overrides = {self._prefill_placement_name: self._prefill_dev,
                         self._decode_placement_name: self._decode_dev}
            overrides[name] = scaled
            # with distinct per-phase engines the decision is meant to
            # actuate, so the DSE is restricted to the hosted pair: a third
            # engine the loop cannot run on would make every decision
            # unactionable advice
            engines = None
            if self._prefill_placement_name != self._decode_placement_name:
                hosted = [ENGINES_BY_NAME[n]
                          for n in (self._prefill_placement_name,
                                    self._decode_placement_name)
                          if n in ENGINES_BY_NAME]
                engines = hosted if len(hosted) == 2 else None
            pool = self.decode.pool
            prompt_len = max(pool.max_seq // 2, 1)
            decision = place_phases(
                self.cfg, engines, objective="latency",
                prompt_len=prompt_len,
                gen_len=max(pool.max_seq - prompt_len, 1),
                batch=pool.n_slots, link_bw=self._handoff_link_bw,
                device_overrides=overrides)
            advice = {"placement_advice": {
                          "prefill_engine": decision.prefill_engine,
                          "decode_engine": decision.decode_engine,
                          "colocated": decision.colocated,
                          "objective": decision.objective,
                          "value": float(decision.best.value)},
                      "drifted_device": scaled.name}
            advice.update(self._actuate_placement(decision))
            return advice
        except Exception as e:           # advice must never kill the run
            return {"placement_advice": None,
                    "placement_error": repr(e)}

    def _actuate_placement(self, decision) -> Dict:
        """Turn a fresh placement decision into a mid-run engine switch.

        Only possible when the two phases price on *distinct* placement
        engine names (otherwise the decision cannot be mapped onto the
        hosted engines and stays advice).  If the decision's decode engine
        is one of the hosted pair and differs from the current decode
        target, the hand-off pipeline drains, the target flips, and
        in-flight decode slots live-migrate (as capacity allows)."""
        if self.spec is not None:
            return {"actuated": False,
                    "reason": "speculative decoding pins the decode engine"}
        if self._prefill_placement_name == self._decode_placement_name:
            return {"actuated": False, "reason": "single-engine placement"}
        target = {self._decode_placement_name: "decode",
                  self._prefill_placement_name: "prefill"}.get(
                      decision.decode_engine)
        if target is None:
            return {"actuated": False,
                    "reason": f"decode engine {decision.decode_engine!r} "
                              f"is not hosted"}
        if target == self._decode_target:
            return {"actuated": False, "decode_target": target}
        self._drain_handoffs(force_all=True)
        self._decode_target = target
        moved = self._live_migrate(target)
        if self.obs.tracer.enabled:
            self.obs.tracer.instant(
                "placement_actuated", track="server", cat="watchdog",
                args={"decode_target": target, "live_migrations": moved})
        return {"actuated": True, "decode_target": target,
                "live_migrations": moved}

    def sample(self, metrics: ServeMetrics) -> None:
        # capacity-weighted across the two pools: occupancy by total_blocks,
        # utilization by allocated-block capacity
        occ, util = sample_pools((self.prefill.pool, self.decode.pool))
        metrics.occupancy.append(occ)
        metrics.utilization.append(util)

    def scan(self, clock: Callable[[], float], metrics: ServeMetrics,
             sink: TokenSink) -> None:
        now = clock()
        # prefill completions -> phase boundary (or a flip in place when the
        # decode target is the prefill engine itself)
        ready_rids = {r.rid for r in self._ready}
        for s, req in enumerate(self.prefill.slots):
            if req is None or req.rid in ready_rids:
                continue
            base = self._fed_base.get(req.rid)
            if base is not None:         # a live-migrated decode slot here
                req.n_fed = base + int(self.prefill.steps_done[s])
            else:
                req.n_fed = (int(self.prefill.steps_done[s])
                             + req.shared_tokens)
            if (req.state is not RequestState.DECODE
                    and self.prefill.steps_done[s]
                    >= self.prefill.steps_total[s]):
                # the burst containing the first sample has been dispatched
                req.state = RequestState.DECODE
                req.t_first_dispatch = now
                trace_phase_flip(self.obs.tracer, req, now)
                if self._decode_target == "prefill":
                    # actuated placement: the prefill engine carries the
                    # decode phase in place (colocated step math, no
                    # hand-off)
                    self.prefill.steps_total[s] += req.max_new_tokens - 1
                else:
                    self._ready.append(req)
                    ready_rids.add(req.rid)
        for s, req in enumerate(self.decode.slots):
            if req is not None:
                base = self._fed_base.get(req.rid, req.prompt_len)
                req.n_fed = base + int(self.decode.steps_done[s])
        # streaming: burst-boundary sync per engine — the prefill engine
        # emits first samples (including parked slots), the decode engine
        # the rest of each generation
        sink.drain(self.prefill, clock)
        sink.drain(self.decode, clock)
        # decode completions, on whichever engine carries the slot now
        tracer = self.obs.tracer
        for eng in (self.decode, self.prefill):
            for s, req in enumerate(eng.slots):
                if (req is None or req.state is not RequestState.DECODE
                        or req.rid in ready_rids):
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
                    self._fed_base.pop(req.rid, None)
                    metrics.observe(req)
                    trace_completion(tracer, req)
