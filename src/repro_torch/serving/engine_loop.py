"""Continuous-batching engine loop on the dense or block-paged KV cache.

One step (`decode_step_slots` dense, `decode_step_slots_paged` paged: the
same contract, the same tokens) advances every active slot by one token per
iteration — prefilling slots consume their next prompt token, decoding
slots consume their previously sampled token — so prefill interleaves with
the running decode batch, and a finished request's slot is refilled at the
next completion boundary.

Token feeding is device-resident: the fused step selects each slot's next
token from an uploaded prompt buffer (while ``pos < prompt_len``) or from the
previous argmax, and scatters sampled tokens into a per-slot output buffer.
The host never syncs per step: completion is deterministic in step count
(greedy decoding, known lengths), so the loop dispatches a *burst* of steps
up to the next completion boundary and only then pulls the finished slots'
rows.  The JAX package scans a burst inside one jitted call.  Here, on a
card, :meth:`SlotEngine.warmup` captures one fused step into a CUDA graph
over the engine's static buffers, and a burst of k steps replays it k times:
one launch per step instead of the ~2,600 kernels an eager step issues.  On
the CPU the same step runs eagerly.

:class:`SlotEngine` holds the slot state and the burst machinery;
:class:`EngineLoop` composes one SlotEngine with a pool and a batcher and
provides the hooks :class:`~repro_torch.serving.driver.OpenLoopDriver`
calls, while :class:`~repro_torch.serving.disagg.DisaggregatedEngineLoop`
composes two — a prefill engine and a decode engine — and migrates slots
between them (:meth:`SlotEngine.export_slot` / :meth:`SlotEngine.adopt`) at
the phase boundary.  The loop is driven by a clock function so tests can run
it reproducibly.

The hand-off differs from the JAX package's in two ways the port's tensors
force.  A torch slice is a view, not a fresh buffer, so every tensor of an
exported snapshot is a copy (a snapshot holding views would change when the
slot is rebound and stepped).  And the CUDA graph reads fixed addresses, so
an import writes into the engine's existing buffers in place instead of
rebinding ``cache``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels.ops import WRAPPERS
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


def capture_graph(fn: Callable[[], None], device, warmup_steps: int):
    """Capture ``fn``, a step that updates static buffers in place, into a
    CUDA graph after ``warmup_steps`` eager calls on the capture stream
    (they meet first-use costs outside the graph and launch their kernels
    like any call).  A capture that fails raises.  Returns the graph and
    the launches one replay makes, per kernel wrapper: capture records the
    kernels' launches without running them, so the counts move to the
    replays (:func:`replay_graph`)."""
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    with torch.no_grad():
        with torch.cuda.stream(stream):
            for _ in range(warmup_steps):
                fn()
        current.wait_stream(stream)
        before = [w.launches for w in WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            fn()
    launches = [(w, w.launches - n) for w, n in zip(WRAPPERS, before)]
    for w, n in zip(WRAPPERS, before):
        w.launches = n
    return graph, launches


def replay_graph(graph, launches, n: int = 1) -> None:
    """Replay a graph of :func:`capture_graph` ``n`` times on the current
    stream and count its kernels' launches."""
    for _ in range(n):
        graph.replay()
    for w, k in launches:
        w.launches += k * n


class SlotEngine:
    """Device-resident slot state + the burst machinery for one engine.

    Owns the slot cache (``kv_layout`` "dense" or "paged"), the
    prompt/output buffers and the per-slot step schedule.  Params are cast
    to the compute dtype once, on ``device``, and every buffer lives there.

    Every buffer the step reads or writes is allocated once and updated in
    place (:meth:`_step`, :meth:`bind`, :meth:`copy_page`, the mask upload
    in :meth:`dispatch`), so the CUDA graph :meth:`warmup` captures on a
    card stays valid for the engine's life.  ``cuda_graph=False`` runs the
    same step eagerly on the card; on the CPU it always runs eagerly.

    Invariants: under the paged layout the pool's lease order IS the block
    table — :meth:`bind` uploads ``KVPool.block_table`` verbatim.  The
    engine writes KV only at each slot's current position, so pages behind
    ``pos`` are immutable (what makes published prefix pages safe to
    share), and pending COW copies are materialized in :meth:`bind` before
    the slot's first write.  :meth:`dispatch` reads the caller's ``active``
    mask once, copying it to the device before it returns, so the caller may
    change its array right after; :meth:`sync` is a pure wait.
    """

    # eager all-inactive steps before the capture: they meet first-use costs
    # (the kernel library's load, cuBLAS's workspace) outside the graph, and
    # launch their kernels on the card like any step
    WARMUP_STEPS = 1

    def __init__(self, cfg: T.ModelConfig, params, pool: KVPool, *,
                 kv_layout: str = "dense", name: str = "engine",
                 device="cuda", cuda_graph: bool = True):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the index its tensors report, so an import can tell a
            # snapshot already here from one on another card
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = T.compute_params(
            T.map_params(lambda _, t: t.to(self.device), params), cfg)
        self.pool = pool
        self.kv_layout = kv_layout
        self.name = name                 # labels this engine's trace track
        n_slots = pool.n_slots
        if kv_layout == "paged":
            self.cache = T.init_slot_cache_paged(
                cfg, n_slots, pool.max_seq, block_size=pool.block_size,
                total_blocks=pool.total_blocks, device=self.device)
            self._step_fn = functools.partial(T.decode_step_slots_paged,
                                              max_seq=pool.max_seq)
        else:
            self.cache = T.init_slot_cache(cfg, n_slots, pool.max_seq,
                                           device=self.device)
            self._step_fn = T.decode_step_slots
        self.max_prompt = pool.max_seq
        self.max_gen = pool.max_seq

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._prompts = zeros(n_slots, self.max_prompt)
        self._plens = zeros(n_slots)
        self._last_tok = zeros(n_slots)
        self._out_buf = zeros(n_slots, self.max_gen)
        self._active = zeros(n_slots, dtype=torch.bool)
        self._rows = torch.arange(n_slots, device=self.device)
        self.logits = None               # (B, 1, V) of the latest step
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self._graph = None
        self._graph_launches = []        # (wrapper, launches per replay)
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
        if self.kv_layout != "paged":
            raise ValueError("copy_page needs the paged KV layout")
        for layer in self.cache["layers"]:
            if _is_arena(layer):
                layer["k"][dst] = layer["k"][src]
                layer["v"][dst] = layer["v"][src]

    def bind(self, req: Request, *, steps_total: int,
             start_pos: int = 0) -> None:
        """Upload the request's prompt into its slot, materialize pending
        COW copies, upload its block table (paged) and reset its position.
        ``steps_total`` is the number of engine steps the request runs
        (plen + gen - 1, minus any prefix-shared tokens).  ``start_pos`` > 0
        binds at an offset (prefix sharing, paged layout only): positions
        ``[0, start_pos)`` are served by shared pages, so the first fed
        token is ``prompt[start_pos]``."""
        if start_pos and self.kv_layout != "paged":
            raise ValueError("bind at an offset (prefix sharing) requires "
                             "the paged KV layout")
        s = req.slot
        row = torch.zeros((self.max_prompt,), dtype=torch.int32)
        row[:req.prompt_len] = torch.from_numpy(
            np.asarray(req.prompt, np.int32))
        self._prompts[s] = row.to(self.device)
        self._plens[s] = req.prompt_len
        if self.kv_layout == "paged":
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

    def _step(self) -> None:
        """Device-side feed + step + sample + output scatter over the slots
        the ``_active`` buffer marks, every write in place (the unit the
        CUDA graph captures)."""
        cache, active, rows = self.cache, self._active, self._rows
        pos = cache["pos"]
        prompt_tok = self._prompts[
            rows, torch.clamp(pos, max=self.max_prompt - 1).long()]
        tok = torch.where(pos < self._plens, prompt_tok, self._last_tok)
        # the sample is output index (pos - plen + 1), taken before the step
        # advances pos in place; valid once the final prompt token is fed
        idx = pos - self._plens + 1
        logits, _ = self._step_fn(self.params, self.cfg, cache, tok[:, None],
                                  active)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        write = active & (idx >= 0) & (idx < self.max_gen)
        safe = torch.clamp(idx, 0, self.max_gen - 1).long()
        self._out_buf[rows, safe] = torch.where(
            write, nxt, self._out_buf[rows, safe])
        self._last_tok.copy_(torch.where(active, nxt, self._last_tok))
        self.logits = logits

    def warmup(self) -> None:
        """On a card (unless ``cuda_graph=False``), capture one step into
        the CUDA graph :meth:`dispatch` replays, after WARMUP_STEPS eager
        steps on the capture stream.  Every step here runs with an
        all-inactive mask, which leaves positions, live KV and the token
        buffers as they were (the paged layout writes only its trash page),
        so this is state-neutral.  A capture that fails raises.  Nothing to
        prepare when the steps run eagerly."""
        if not self.cuda_graph or self._graph is not None:
            return
        self._active.zero_()
        self._graph, self._graph_launches = capture_graph(
            self._step, self.device, self.WARMUP_STEPS)

    def dispatch(self, burst: int, active_np: np.ndarray) -> None:
        """Queue ``burst`` steps over the slots ``active_np`` marks, without
        a host sync: graph replays on a card, eager steps otherwise.  The
        mask is copied into the engine's device buffer here, so changing
        ``active_np`` after this returns cannot reach the queued steps."""
        if self.cuda_graph and self._graph is None:
            self.warmup()
        self._active.copy_(torch.from_numpy(np.array(active_np, bool)))
        if self._graph is not None:
            replay_graph(self._graph, self._graph_launches, burst)
        else:
            with torch.no_grad():
                for _ in range(burst):
                    self._step()
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

    # ---- slot hand-off (phase disaggregation) ----------------------------
    def export_slot(self, s: int) -> Dict:
        """Snapshot every per-slot tensor a request needs to resume on
        another engine: its KV, recurrent states, position, the slot's
        cross-attention row (an encoder-decoder's or vision config's
        cache), prompt row, feed state and sampled-output row.  This is the
        payload the placement analyzer prices with the offload-overhead
        model.

        Every tensor is a fresh copy, queued on the current stream behind
        the engine's steps: the slot may be rebound and stepped (a queued
        graph replay writes its rows) while the snapshot is held.  The
        dense layout ships the slot's whole ``max_seq`` KV rows; the paged
        layout ships only the pages that hold written tokens (``kv_tokens``
        of them), gathered from the arena; recurrent states are slot-major
        in either layout and ship as the slot's rows.  On a card, ``ready``
        is an event recorded after the copies (:func:`snapshot_ready`)."""
        state = {
            "layout": self.kv_layout,
            "pos": self.cache["pos"][s].clone(),
            "cross": None,
            "prompt": self._prompts[s].clone(),
            "plen": self._plens[s].clone(),
            "last_tok": self._last_tok[s].clone(),
            "out_row": self._out_buf[s].clone(),
        }
        cross = self.cache.get("cross")
        if cross is not None:
            state["cross"] = cross[s].clone()
        if self.kv_layout == "paged":
            lease = self.pool.lease(self.slots[s].rid)
            n_used = math.ceil(lease.written_tokens / self.pool.block_size)
            phys = torch.tensor(lease.blocks[:n_used], dtype=torch.long,
                                device=self.device)
            state["kv_tokens"] = lease.written_tokens

        def take(layer):
            if self.kv_layout == "paged" and _is_arena(layer):
                return {name: a.index_select(0, phys)
                        for name, a in layer.items()}
            return _map_tensors(lambda a: a[s].clone(), layer)

        state["layers"] = [take(layer) for layer in self.cache["layers"]]
        state["ready"] = (_record_event(torch.cuda.current_stream(
            self.device)) if self.device.type == "cuda" else None)
        return state

    def import_slot(self, s: int, state: Dict, *,
                    dest_blocks: Optional[List[int]] = None,
                    skip_blocks: int = 0) -> None:
        """Install an exported slot snapshot into slot ``s`` (bit-exact:
        the imported request decodes the same tokens it would have produced
        had it stayed on the exporting engine).

        Every write lands in place in the engine's existing buffers, so the
        captured graph's replays read the imported state.  The current
        stream first waits for the snapshot's copies.  Paged layout: the
        shipped pages land in this engine's arena at ``dest_blocks`` (the
        slot's new lease, logical order) and the slot's block table is
        rebuilt from that lease — physical page ids never migrate across
        engines.  ``skip_blocks`` leading logical pages are NOT landed
        (prefix sharing: the destination lease already maps them onto
        shared pages holding bit-identical content, which must not be
        written).  The slot's cross row is migrated, not shared: a
        snapshot and an engine that disagree on having one raise."""
        if any(t.device != self.device for t in _tensor_leaves(state)):
            state = state_to_device(state, self.device)
        layout = state.get("layout", "dense")
        if layout != self.kv_layout:
            raise ValueError(
                f"exported slot uses the {layout!r} KV layout but the "
                f"importing engine runs {self.kv_layout!r} — phase engines "
                f"must share a layout for exact migration")
        cross = self.cache.get("cross")
        if cross is not None and state.get("cross") is None:
            raise ValueError(
                "cross-attention cache present on the importing engine "
                "but the exported slot carries no cross row — the "
                "exporting engine was built for a different config")
        if cross is None and state.get("cross") is not None:
            raise ValueError(
                "exported slot carries a cross-attention row but the "
                "importing engine has no cross cache — silently dropping "
                "it would corrupt the migrated request (engines built for "
                "different configs)")
        if self.kv_layout == "paged":
            if dest_blocks is None:
                raise ValueError("paged import needs dest_blocks (the "
                                 "slot's lease on this engine)")
            n_used = math.ceil(int(state["kv_tokens"])
                               / self.pool.block_size)
            if n_used > len(dest_blocks):
                raise ValueError(
                    f"snapshot carries {n_used} written pages but the "
                    f"destination lease holds {len(dest_blocks)} blocks")
            skip = min(skip_blocks, n_used)
        ready = state.get("ready")
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        if self.kv_layout == "paged":
            phys = torch.tensor(dest_blocks[skip:n_used], dtype=torch.long,
                                device=self.device)
            table = np.zeros((self.cache["block_tables"].shape[1],),
                             np.int32)
            table[:len(dest_blocks)] = dest_blocks
            self.cache["block_tables"][s].copy_(torch.from_numpy(table))
        for layer, shipped in zip(self.cache["layers"], state["layers"]):
            if self.kv_layout == "paged" and _is_arena(layer):
                for name, a in layer.items():
                    a.index_copy_(0, phys, shipped[name][skip:n_used])
            else:
                for a, b in _tensor_pairs(layer, shipped):
                    a[s].copy_(b)
        self.cache["pos"][s].copy_(state["pos"])
        if cross is not None:
            cross[s].copy_(state["cross"])
        self._prompts[s].copy_(state["prompt"])
        self._plens[s].copy_(state["plen"])
        self._last_tok[s].copy_(state["last_tok"])
        self._out_buf[s].copy_(state["out_row"])

    def adopt(self, req: Request, state: Dict, *, steps_total: int,
              skip_blocks: int = 0) -> None:
        """Take over a migrated request: install its snapshot into the slot
        the pool already assigned (``req.slot``) and reset the per-slot
        schedule for the steps this engine owes.  ``skip_blocks`` passes
        through to :meth:`import_slot` (prefix-shared leading pages)."""
        s = req.slot
        dest = (self.pool.lease(req.rid).blocks
                if self.kv_layout == "paged" else None)
        self.import_slot(s, state, dest_blocks=dest,
                         skip_blocks=skip_blocks)
        self.slots[s] = req
        self.steps_done[s] = 0
        self.steps_total[s] = steps_total
        self.active[s] = True

    @staticmethod
    def state_nbytes(state: Dict) -> int:
        """Byte size of an exported slot snapshot (the hand-off payload),
        the cross row included.  Non-tensor metadata (layout tag,
        written-token count, the ready event) is free."""
        return sum(int(t.nbytes) for t in _tensor_leaves(state))


def _is_arena(layer: Dict) -> bool:
    """An attention layer's K/V entry (rows or arenas), as opposed to a
    recurrent layer's state."""
    return "k" in layer


def _tensor_pairs(dst, src):
    """(dst, src) leaf pairs of two trees of one structure."""
    if isinstance(dst, torch.Tensor):
        yield dst, src
    else:
        for key in dst:
            yield from _tensor_pairs(dst[key], src[key])


def _tensor_leaves(tree):
    """Every tensor of a snapshot (nested dicts and lists)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _record_event(stream) -> "torch.cuda.Event":
    event = torch.cuda.Event()
    event.record(stream)
    return event


def state_to_device(state: Dict, device) -> Dict:
    """Copy every tensor of an exported slot snapshot into new storage on
    ``device`` (non-tensor metadata passes through), the copy being real
    on the same device too.

    On a card the copies run on a side stream that first waits for the
    snapshot's ``ready`` event (the export's copies) and for ``device``'s
    current stream (the destination buffers' allocation), so this returns at once and the exporting engine keeps
    stepping while the bytes move.  Each source gets ``record_stream`` on
    the side stream, so the caching allocator cannot hand its memory out
    before the copy has read it; the snapshot's ``ready`` event is recorded
    after the copies (:func:`snapshot_ready`, :func:`snapshot_wait`).  Off
    a card it is a plain synchronous copy."""
    device = torch.device(device)
    if device.type != "cuda":
        out = _map_tensors(lambda t: t.to(device, copy=True), state)
        out["ready"] = None
        return out
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    if state.get("ready") is not None:
        side.wait_event(state["ready"])

    def copy(t: torch.Tensor) -> torch.Tensor:
        dst = torch.empty_like(t, device=device)
        with torch.cuda.stream(side):
            dst.copy_(t, non_blocking=True)
        if t.device.type == "cuda":
            t.record_stream(side)
        dst.record_stream(side)
        return dst

    out = _map_tensors(copy, state)
    out["ready"] = _record_event(side)
    return out


def snapshot_ready(state: Dict) -> bool:
    """True when a snapshot's copies have finished (non-blocking — the
    overlap probe)."""
    ready = state.get("ready")
    return ready is None or ready.query()


def snapshot_wait(state: Dict) -> None:
    """Block until a snapshot's copies complete (the stall the hand-off
    ledger charges to the adopting engine)."""
    ready = state.get("ready")
    if ready is not None:
        ready.synchronize()


def check_prefix_sharing(cfg: T.ModelConfig, kv_layout: str) -> None:
    """Raise on a loop that cannot share prefix pages: a dense layout, or a
    config with recurrent layers, whose slot-local state no shared page
    holds."""
    if kv_layout != "paged":
        raise ValueError("prefix sharing maps physical pages — it "
                         "requires kv_layout='paged'")
    if any(t != "attn" for t in cfg.layer_types()):
        raise ValueError(
            "prefix sharing requires an all-attention config: "
            "recurrent/cross layer state is slot-local and cannot "
            "be reconstructed from shared KV pages")


class EngineLoop:
    """Colocated serving: one SlotEngine runs both phases of every request.

    The open-loop scaffolding lives in :class:`~repro_torch.serving.driver.
    OpenLoopDriver`; this class provides the hook implementations
    (admission binds the request onto the engine, completion pulls the
    whole output row).  ``device`` defaults to the card, where the steps
    replay a CUDA graph unless ``cuda_graph=False``.
    """

    def __init__(self, cfg: T.ModelConfig, params, *, n_slots: int,
                 max_seq: int, block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 kv_layout: str = "paged",
                 device_name: str = "nvidia-h100",
                 device_model=None,
                 step_slo_s: Optional[float] = None,
                 token_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 obs: Optional[Observability] = None,
                 device="cuda", cuda_graph: bool = True):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EngineLoop: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if prefix_sharing:
            check_prefix_sharing(cfg, kv_layout)
        self.cfg = cfg
        self.kv_layout = kv_layout
        self.prefix_sharing = prefix_sharing
        self.obs = obs if obs is not None else Observability()
        self.pool = KVPool(n_slots, max_seq, block_size=block_size,
                           total_blocks=total_blocks,
                           prefix_sharing=prefix_sharing)
        self.batcher = ContinuousBatcher(
            cfg, self.pool, device_name=device_name,
            device_model=device_model, step_slo_s=step_slo_s,
            token_budget=token_budget)
        self.engine = SlotEngine(cfg, params, self.pool, kv_layout=kv_layout,
                                 name="colocated", device=device,
                                 cuda_graph=cuda_graph)
        wire_pool_events(self.pool, self.obs.tracer)

    def warmup(self) -> None:
        self.engine.warmup()

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
              metrics: ServeMetrics):
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
        return decision

    def dispatch(self, throttle: bool, budget: Optional[int]) -> int:
        # burst: dispatch steps to the next completion boundary without
        # any host sync; the card runs behind the dispatch
        eng = self.engine
        remaining = eng.steps_total - eng.steps_done
        burst = burst_size(int(remaining[eng.active].min()),
                           throttle=throttle, budget=budget)
        if burst <= 0:
            return 0
        tracer, fb, wd = self.obs.tracer, self.obs.feedback, self.obs.watchdog
        n_active = eng.n_active
        h = (tracer.begin("burst", track=f"engine:{eng.name}", cat="engine",
                          args={"steps": burst, "n_active": n_active})
             if tracer.enabled else None)
        timed = fb is not None or wd is not None
        t0 = tracer.now() if timed else 0.0
        eng.dispatch(burst, eng.active)
        if timed:
            # telemetry feedback / the watchdog want the card's time per
            # step, so wait for the burst (a pure wait: outputs stay
            # bit-identical)
            eng.sync()
            dt = tracer.now() - t0
            if fb is not None:
                fb.observe_burst(n_active, burst, dt)
            if wd is not None:
                wd.observe_burst(
                    eng.name, self.batcher.phase, n_tokens=n_active,
                    steps=burst, elapsed_s=dt,
                    priced_step_s=self.batcher.priced_step_s(n_active))
        if h is not None:
            tracer.end(h, args={"synced": timed})
        return burst

    def on_drift(self, alert, watchdog) -> None:
        """Watchdog action leg: re-price admission from observed telemetry.

        Installs the best pricing the watchdog can offer — a fitted
        latency(batch) curve once >= 2 batch sizes were observed, the
        analytic shape scaled by the observed divergence ratio otherwise —
        and refits the token budget against the stored step SLO.  Pure
        admission policy: per-request greedy outputs are schedule-
        independent, so re-pricing never changes what is generated.
        """
        fn, source = watchdog.step_time_fn(
            alert.engine, alert.phase, self.batcher.analytic_step_s)
        if source == "analytic":
            return                       # nothing observed: keep the model
        detail = self.batcher.reprice(fn, source=source)
        watchdog.note_reprice(alert, detail)

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
