"""Draft-model speculative decoding on the paged serving path.

The paper's trade-off move — price the same work on a cheap and an
expensive engine and offload by measured trade-off — applied to the decode
hot path: a *draft* model proposes k tokens per slot, the *target* verifies
all k in ONE multi-token step over its paged KV cache
(`decode_multi_step_slots_paged`), and only the accepted prefix commits.
The JAX package's ``serving/speculative.py``, on the port's slot engines.

Round math (greedy verification, per slot, from committed position pos0
whose chain head token is ``last_tok``):

* the draft autoregressively proposes d_1..d_k (k+1 sequential draft steps
  on the paged-attention kernel — the extra feed writes draft KV for d_k so
  a fully-accepted round leaves the draft cache one rollback away from the
  new head);
* the target feeds [last_tok, d_1..d_k] at positions pos0..pos0+k in one
  step, producing greedy continuations g_1..g_{k+1} where g_j conditions on
  the window prefix up to input j;
* accepted a = longest prefix with d_i == g_i; committed c = min(a + 1,
  rem) — the +1 is the target's own token (the correction after a
  rejection, the bonus token after full acceptance);
* pos += c, the new chain head is g_c, and both caches roll their position
  back to the committed prefix.  Positions pos0+c..pos0+k hold *stale* K/V
  from the rejected tail — harmless, because every later feed starts at the
  committed position and rewrites forward before attention reads them.

Every committed token is a target greedy continuation of the committed
chain plain decode walks, so outputs are those of plain decoding wherever
the verify step's logits equal sequential steps' (bit for bit under the
``ref`` impl on the CPU, and on an H100 for the windows ``chip_smoke.py``
phase 7 gates, 8 slots x 3 tokens and 32 x 5: the verify is k+1 plain
steps, so no product holds more rows than a plain step's, and under the
``hopper`` impl it runs the plain step's kernel).  Expected committed tokens per round is
sum_{i=1..k} alpha^i + 1 for per-token acceptance rate alpha
(`core.cost_model.expected_tokens_per_round`).

Safety gate: a slot only enters a round while ``rem >= k`` (rem = steps
still owed), which pins the verify window's top position pos0+k inside the
slot's page lease.  The pool's block table pads with physical page 0, so an
overflow write would corrupt another request's pages — the gate makes that
impossible instead of masking it.  Tail slots (rem < k) finish via plain
bursts.

The draft engine needs no KVPool: slot s statically owns pages [s*bps,
(s+1)*bps), its cache is a throwaway mirror of the committed chain, and a
rejection rollback is a position move.  Draft slot indices equal target
slot indices, so the loops' active masks line up.

What PyTorch changes.  The JAX package jits the draft's k+1 steps and the
verify step once per k; here, on a card, each is captured once per k into a
CUDA graph over static buffers — the draft's cache, token and mask buffers,
and for the verify the target engine's own ``cache``, ``_last_tok`` and
``_out_buf`` — and a round replays both.  The verify writes all of those in
place, so the target engine's step graph replays on the same storage in the
next plain burst.  ``cuda_graph=False``, and every CPU tensor, run the same
code eagerly.  The draft's catch-up (:meth:`DraftEngine.sync_to`) stays
eager: its length and start change per call.  A round makes one host pull
(committed and accepted counts together), as in the JAX package.  With
telemetry feedback or the performance watchdog on, a round is synced and
timed like a plain burst, its committed tokens per slot counted as
fractional steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models import transformer as T
from .engine_loop import EngineLoop, capture_graph, replay_graph

__all__ = ["DEFAULT_ACCEPTANCE_PRIOR", "DEFAULT_DRAFT_ARCH",
           "DEFAULT_DRAFT_K", "DraftEngine", "SpecPlan",
           "SpeculativeDecoder", "SpeculativeEngineLoop", "spec_dispatch",
           "validate_speculation"]

DEFAULT_DRAFT_ARCH = "qwen2_1_5b"
DEFAULT_DRAFT_K = 2
# acceptance prior used before any measurement exists for a (draft, target)
# pair — optimistic enough to let speculation engage so the online tracker
# can measure the real rate and veto it
DEFAULT_ACCEPTANCE_PRIOR = 0.8


def validate_speculation(target_cfg, draft_cfg, *, kv_layout: str,
                         prefix_sharing: bool) -> None:
    """Raise on serving configurations speculation cannot run under."""
    if kv_layout != "paged":
        raise ValueError("speculative decoding verifies k+1 positions "
                         "against the block-paged cache — it requires "
                         "kv_layout='paged'")
    if prefix_sharing:
        raise ValueError(
            "speculative decoding is incompatible with prefix sharing: "
            "shared-offset binds break the draft's committed-chain replay "
            "and a rejected window must never land in refcounted pages")
    for role, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if any(t != "attn" for t in cfg.layer_types()):
            raise ValueError(
                f"speculative decoding requires an all-attention {role} "
                f"config ({cfg.name!r}): recurrent/SSM state has no "
                f"multi-token verify or rollback")
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab} != target vocab "
            f"{target_cfg.vocab}: proposals would not be target tokens")


@dataclasses.dataclass
class SpecPlan:
    """Everything the serving loop needs to speculate: the draft model,
    the depth, and how the decision was made (forced CLI depth vs the
    trade-off analyzer's `choose_speculation`)."""
    draft_cfg: T.ModelConfig
    draft_params: object
    k: int = DEFAULT_DRAFT_K
    draft_name: str = DEFAULT_DRAFT_ARCH
    decision: object = None      # placement.SpeculationDecision | None
    forced: bool = False         # --draft-k: speculate regardless of price
    tracker: object = None       # obs.watchdog.AcceptanceTracker | None


class DraftEngine:
    """The draft model's paged slot cache, dense-equivalently provisioned.

    Mirrors the target engine's committed chain per slot: :meth:`sync_to`
    replays chain tokens the draft has not seen (prompt tokens from the
    target's prompt buffer, committed generations from its output buffer —
    both on the device, so catch-up never syncs the host) in one
    multi-token step; :meth:`propose` runs k+1 sequential draft steps;
    :meth:`rollback` moves positions back to the committed prefix after
    verification.  On a card (unless ``cuda_graph=False``) a proposal of
    depth k is a replay of a CUDA graph captured at its first use.
    """

    # eager all-inactive proposals before each capture (state-neutral: the
    # steps write only the trash page)
    WARMUP_ROUNDS = 1

    def __init__(self, cfg: T.ModelConfig, params, *, n_slots: int,
                 max_seq: int, block_size: int = 16, device="cuda",
                 cuda_graph: bool = True):
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.params = T.compute_params(
            T.map_params(lambda _, t: t.to(self.device), params), cfg)
        self.cache = T.init_slot_cache_paged(cfg, n_slots, max_seq,
                                             block_size=block_size,
                                             device=self.device)
        bps = self.cache["block_tables"].shape[1]
        self.cache["block_tables"].copy_(torch.arange(
            n_slots * bps, dtype=torch.int32).reshape(n_slots, bps))
        # host view of each draft slot's committed position (== cache
        # "pos" between rounds, so eligibility checks never pull the device)
        self.pos = np.zeros((n_slots,), np.int64)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self._tok = torch.zeros((n_slots,), dtype=torch.int32,
                                device=self.device)
        self._active = torch.zeros((n_slots,), dtype=torch.bool,
                                   device=self.device)
        self._proposals: Dict[int, torch.Tensor] = {}
        self._graphs: Dict[int, tuple] = {}

    def reset_slot(self, slot: int) -> None:
        T.reset_slot_state(self.cfg, self.cache, slot)
        self.pos[slot] = 0

    def sync_to(self, slot: int, target_pos: int, *, prompts, plens,
                out_buf) -> None:
        """Feed the draft cache the chain tokens [pos, target_pos) of one
        slot — initial enrollment (pos 0 -> plen and on) and catch-up after
        plain bursts advanced the target without the draft — as one
        multi-token step over that slot alone (a view of its position and
        block-table row; the arenas are shared), its window contracted at
        once (``stepwise=False``: the draft's numbers only steer its
        proposals, and step by step a prompt-long window is a loop of
        single-token steps that cut forced speculation from 73.3 to 11.7
        tok/s on an H100 in ``chip_smoke.py`` phase 10)."""
        start = int(self.pos[slot])
        if int(target_pos) <= start:
            return
        cols = torch.arange(start, int(target_pos), device=self.device)
        plen = plens[slot]
        # out_buf[x] holds the token at absolute position plen + x (the
        # engine's step scatter)
        gen = out_buf[slot, torch.clamp(cols - plen, 0,
                                        out_buf.shape[1] - 1)]
        prompt = prompts[slot, torch.clamp(cols, max=prompts.shape[1] - 1)]
        chain = torch.where(cols < plen, prompt, gen)
        one = slice(slot, slot + 1)
        view = {"layers": self.cache["layers"], "pos": self.cache["pos"][one],
                "block_tables": self.cache["block_tables"][one]}
        with torch.no_grad():
            T.decode_multi_step_slots_paged(
                self.params, self.cfg, view, chain[None],
                torch.ones((1,), dtype=torch.bool, device=self.device),
                max_seq=self.max_seq, advance=True, stepwise=False)
        self.pos[slot] = int(target_pos)

    def proposals(self, k: int) -> torch.Tensor:
        """The (n_slots, k) buffer depth-k proposals land in."""
        buf = self._proposals.get(k)
        if buf is None:
            buf = torch.zeros((self._tok.shape[0], k), dtype=torch.int32,
                              device=self.device)
            self._proposals[k] = buf
        return buf

    def _propose(self, k: int) -> None:
        """k+1 draft steps over the masked slots from the ``_tok`` buffer,
        the first k argmaxes into :meth:`proposals` — every write in place
        (the unit the CUDA graph captures)."""
        tok, a, out = self._tok, self._active, self.proposals(k)
        # k+1 steps: the last feed writes draft KV for d_k, so a fully
        # accepted round's rollback lands on a cache that already holds the
        # whole committed window
        for i in range(k + 1):
            logits, _ = T.decode_step_slots_paged(
                self.params, self.cfg, self.cache, tok[:, None], a,
                max_seq=self.max_seq)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            if i < k:
                out[:, i] = nxt
            tok.copy_(torch.where(a, nxt, tok))

    def warmup(self, k: int) -> None:
        """On a card (unless ``cuda_graph=False``), capture the depth-k
        proposal, after WARMUP_ROUNDS eager all-inactive proposals."""
        if not self.cuda_graph or k in self._graphs:
            return
        self._active.zero_()
        self._graphs[k] = capture_graph(lambda: self._propose(k),
                                        self.device, self.WARMUP_ROUNDS)

    def propose(self, k: int, last_tok: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
        """Depth-k proposals (n_slots, k) for the slots ``active`` marks,
        from each slot's chain head ``last_tok``; the draft positions of
        those slots advance by k+1."""
        self.warmup(k)
        self._tok.copy_(last_tok)
        self._active.copy_(active)
        if k in self._graphs:
            replay_graph(*self._graphs[k])
        else:
            with torch.no_grad():
                self._propose(k)
        return self.proposals(k)

    def rollback(self, k: int, commit: torch.Tensor,
                 active: torch.Tensor) -> None:
        """After verify: active slots sit at pos0 + k + 1; move them back to
        the committed head pos0 + c (on the device — ``commit`` stays there,
        no host round trip)."""
        pos = self.cache["pos"]
        pos.copy_(torch.where(active, pos + commit - (k + 1), pos))


class SpeculativeDecoder:
    """One target SlotEngine's speculative decode state: the draft engine,
    the verify step (a CUDA graph per k on a card), per-run acceptance
    accounting, and the online veto (an `AcceptanceTracker` re-runs the
    trade-off decision as measured acceptance drifts; a negative decision
    disables speculation for the rest of the run and the loop re-prices
    admission back to plain decode).

    ``propose_override(round_index, proposals) -> proposals`` lets tests
    corrupt the draft's proposals deterministically (forcing rejection at a
    chosen window offset); it sees and returns host arrays, so it costs a
    sync and exists for tests only.  A draft that is the target
    (``plan.draft_params`` is ``target_params``, the weights the engine was
    built from, and the configs are equal) shares the engine's cast
    weights instead of casting its own copy.
    """

    def __init__(self, engine, plan: SpecPlan, *,
                 propose_override: Optional[Callable] = None,
                 target_params=None):
        if engine.kv_layout != "paged":
            raise ValueError("speculative decoding requires a paged engine")
        validate_speculation(engine.cfg, plan.draft_cfg,
                             kv_layout=engine.kv_layout,
                             prefix_sharing=engine.pool.prefix_sharing)
        self.eng = engine
        self.plan = plan
        shared = (target_params is not None
                  and plan.draft_params is target_params
                  and plan.draft_cfg == engine.cfg)
        self.draft = DraftEngine(
            plan.draft_cfg, engine.params if shared else plan.draft_params,
            n_slots=engine.pool.n_slots, max_seq=engine.pool.max_seq,
            block_size=engine.pool.block_size, device=engine.device,
            cuda_graph=engine.cuda_graph)
        self.propose_override = propose_override
        n, dev = engine.pool.n_slots, engine.device
        # the round's static inputs, and its one host pull: per-slot
        # committed (row 0) and accepted (row 1) counts
        self._active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._rem = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._counts = torch.zeros((2, n), dtype=torch.int32, device=dev)
        self._verify_graphs: Dict[int, tuple] = {}
        self.enabled = True
        self.disabled_midrun = False
        self._veto_handled = True
        self.n_rounds = 0
        self.n_proposed = 0
        self.n_accepted = 0
        self.n_committed = 0

    def reset_slot(self, slot: int) -> None:
        self.draft.reset_slot(slot)

    def sync_drafts(self, pos: np.ndarray, mask: np.ndarray) -> None:
        """Bring every masked slot's draft cache up to the target's
        committed position (no-op for already-synced slots)."""
        eng = self.eng
        for s in np.flatnonzero(mask):
            if self.draft.pos[s] != pos[s]:
                self.draft.sync_to(int(s), int(pos[s]),
                                   prompts=eng._prompts, plens=eng._plens,
                                   out_buf=eng._out_buf)

    def _verify(self, k: int) -> None:
        """Verify the draft's depth-k proposals for the slots ``_active``
        marks: one (k+1)-token target step, then commit, scatter the
        committed tokens into the output buffer, move the chain head and
        the positions — every write in place into the target engine's own
        buffers (the unit the CUDA graph captures)."""
        eng, a = self.eng, self._active
        pos, out_buf = eng.cache["pos"], eng._out_buf
        draft_toks = self.draft.proposals(k)
        pos0 = pos.clone()
        toks = torch.cat([eng._last_tok[:, None], draft_toks], dim=1)
        logits, _ = T.decode_multi_step_slots_paged(
            eng.params, eng.cfg, eng.cache, toks, a,
            max_seq=eng.pool.max_seq, advance=False)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, k+1)
        # accepted = longest agreeing draft prefix; committed adds the
        # target's own next token, clamped to the steps owed
        match = (draft_toks == greedy[:, :k]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        commit = torch.where(
            a, torch.minimum(acc + 1, torch.clamp(self._rem, min=1)), 0)
        # scatter committed tokens: greedy[:, j] is the chain token at
        # absolute position pos0 + j + 1, stored at out_buf[pos0 + j + 1 -
        # plen] (the layout of the engine's step).  Indices collide only
        # where nothing is written (inactive slots, clamped offsets), and
        # every such write stores the value already there
        g = out_buf.shape[1]
        j = torch.arange(k + 1, device=pos.device)[None, :]
        idx = pos0[:, None] + j - eng._plens[:, None] + 1
        write = (a[:, None] & (j < commit[:, None])
                 & (idx >= 0) & (idx < g))
        safe = torch.clamp(idx, 0, g - 1).long()
        rows = eng._rows[:, None]
        out_buf[rows, safe] = torch.where(write, greedy, out_buf[rows, safe])
        last = torch.gather(greedy, 1,
                            torch.clamp(commit - 1, 0, k)[:, None].long())
        eng._last_tok.copy_(torch.where(a, last[:, 0], eng._last_tok))
        pos.copy_(torch.where(a, pos0 + commit, pos0))
        self._counts[0].copy_(commit)
        self._counts[1].copy_(acc)

    def warmup(self) -> None:
        """On a card (unless the engine steps eagerly), capture the draft's
        proposal and the verify step at the plan's depth, each after eager
        all-inactive calls (state-neutral: inactive slots write only the
        trash page and keep every position and token).  Rounds capture on
        first use otherwise."""
        k = self.plan.k
        if not self.eng.cuda_graph or k in self._verify_graphs:
            return
        self.draft.warmup(k)
        self._active.zero_()
        self._verify_graphs[k] = capture_graph(lambda: self._verify(k),
                                               self.eng.device, 1)

    def round(self, mask: np.ndarray, rem: np.ndarray) -> np.ndarray:
        """One speculative round over the masked slots (drafts must be
        synced).  Returns per-slot committed-token counts — the round's
        single host pull."""
        eng, k = self.eng, self.plan.k
        self.warmup()
        self._active.copy_(torch.from_numpy(np.array(mask, bool)))
        self._rem.copy_(torch.from_numpy(rem.astype(np.int32)))
        proposals = self.draft.propose(k, eng._last_tok, self._active)
        if self.propose_override is not None:
            proposals.copy_(torch.from_numpy(np.asarray(
                self.propose_override(self.n_rounds,
                                      proposals.cpu().numpy()),
                dtype=np.int32)))
        if k in self._verify_graphs:
            replay_graph(*self._verify_graphs[k])
        else:
            with torch.no_grad():
                self._verify(k)
        self.draft.rollback(k, self._counts[0], self._active)
        counts = self._counts.cpu().numpy()
        c = counts[0].astype(np.int64)
        self.draft.pos[mask] += c[mask]
        n = int(mask.sum())
        accepted = int(counts[1][mask].sum())
        self.n_rounds += 1
        self.n_proposed += k * n
        self.n_accepted += accepted
        self.n_committed += int(c[mask].sum())
        tracker = self.plan.tracker
        if tracker is not None and self.enabled:
            tracker.observe_round(k * n, accepted)
            if tracker.disabled:
                self.enabled = False
                self.disabled_midrun = True
                self._veto_handled = False
        return c

    def take_veto(self) -> bool:
        """True exactly once, when the tracker just vetoed speculation —
        the loop reacts by re-pricing admission back to plain decode."""
        if self._veto_handled:
            return False
        self._veto_handled = True
        return True

    @property
    def acceptance_rate(self) -> Optional[float]:
        if self.n_proposed <= 0:
            return None
        return self.n_accepted / self.n_proposed

    def stats(self) -> Dict:
        """JSON-safe per-run speculation accounting."""
        d = {"draft": self.plan.draft_name, "k": self.plan.k,
             "forced": self.plan.forced, "n_rounds": self.n_rounds,
             "n_proposed": self.n_proposed, "n_accepted": self.n_accepted,
             "n_committed": self.n_committed,
             "acceptance_rate": self.acceptance_rate,
             "enabled": self.enabled,
             "disabled_midrun": self.disabled_midrun}
        if self.plan.tracker is not None:
            d["tracker"] = self.plan.tracker.report()
        if self.plan.decision is not None:
            d["decision"] = self.plan.decision.summary()
        return d


def spec_dispatch(spec: SpeculativeDecoder, eng, pool, batcher, obs, *,
                  mask: np.ndarray, pos: np.ndarray, rem: np.ndarray,
                  budget: Optional[int]) -> int:
    """One speculative round under the serving loops' dispatch contract
    (burst span, synced feedback/watchdog observation, pool write
    accounting, the veto's re-price).  Returns the step count the round is
    credited with: the most committed tokens of any of its slots."""
    if budget is not None and budget <= 0:
        return 0
    tracer, fb, wd = obs.tracer, obs.feedback, obs.watchdog
    spec.sync_drafts(pos, mask)
    n_active = int(mask.sum())
    h = (tracer.begin("burst", track=f"engine:{eng.name}", cat="engine",
                      args={"steps": spec.plan.k + 1, "n_active": n_active,
                            "speculative": True})
         if tracer.enabled else None)
    timed = fb is not None or wd is not None
    t0 = tracer.now() if timed else 0.0
    c = spec.round(mask, rem)
    committed = int(c[mask].sum())
    eng.steps_done[mask] += c[mask]
    for s in np.flatnonzero(mask):
        req = eng.slots[s]
        if req is not None and c[s] > 0:
            pool.note_write(req.rid, int(c[s]))
    if timed:
        eng.sync()
        dt = tracer.now() - t0
        # per-slot committed tokens this round, as fractional "steps": the
        # watchdog/feedback contract is wall time per step per token
        steps = committed / max(n_active, 1)
        if fb is not None:
            fb.observe_burst(n_active, steps, dt)
        if wd is not None:
            wd.observe_burst(eng.name, batcher.phase, n_tokens=n_active,
                             steps=steps, elapsed_s=dt,
                             priced_step_s=batcher.priced_step_s(n_active))
    if h is not None:
        tracer.end(h, args={"synced": timed, "committed": committed})
    if spec.take_veto():
        # measured acceptance re-priced speculation worse than plain
        # decode: admission returns to the analytic plain-step model
        detail = batcher.reprice(batcher.analytic_step_s,
                                 source="speculation-disabled")
        if tracer.enabled:
            tracer.instant("speculation_disabled", track="server",
                           cat="watchdog", args=detail)
    return int(c[mask].max()) if n_active else 0


class SpeculativeEngineLoop(EngineLoop):
    """Colocated serving with draft-model speculation on the decode phase.

    Dispatch policy per driver iteration: when every burstable slot is
    decode-phase with ``rem >= k`` (the page-lease safety gate), run one
    speculative round — drafts are first synced to each slot's committed
    chain, which covers both initial enrollment at the phase flip and
    catch-up after plain bursts advanced the target alone.  Any other mix
    (prefilling slots, rem < k tails) falls back to the plain burst path
    unchanged.
    """

    def __init__(self, cfg, params, *, plan: SpecPlan,
                 propose_override: Optional[Callable] = None, **kwargs):
        super().__init__(cfg, params, **kwargs)
        self.spec = SpeculativeDecoder(self.engine, plan,
                                       propose_override=propose_override,
                                       target_params=params)

    def warmup(self) -> None:
        super().warmup()
        self.spec.warmup()

    def admit(self, queue, now, metrics):
        decision = super().admit(queue, now, metrics)
        for req in decision.admitted:
            self.spec.reset_slot(req.slot)
        return decision

    def dispatch(self, throttle: bool, budget: Optional[int]) -> int:
        eng = self.engine
        if self.spec.enabled:
            burstable = eng.active & (eng.steps_done < eng.steps_total)
            if burstable.any():
                plens = np.array([0 if r is None else r.prompt_len
                                  for r in eng.slots], np.int64)
                pos = eng.steps_done     # prefix sharing excluded: offset 0
                rem = eng.steps_total - eng.steps_done
                eligible = (burstable & (pos >= plens)
                            & (rem >= self.plan.k))
                if eligible[burstable].all():
                    return spec_dispatch(
                        self.spec, eng, self.pool, self.batcher, self.obs,
                        mask=burstable, pos=pos, rem=rem, budget=budget)
        return super().dispatch(throttle, budget)

    @property
    def plan(self) -> SpecPlan:
        return self.spec.plan
