"""The programmatic serving API: ``serve(ServeOptions) -> ServeReport``.

Everything ``python -m repro_torch.launch.serve`` can do is driven through
one typed entry point, as in the JAX package's ``serving/api.py``:

    from repro_torch.serving.api import ServeOptions, serve
    opts = ServeOptions()
    opts.workload.scale = "full"
    report = serve(opts)                  # on the card
    print(report.summary["tok_per_s"])

``ServeOptions`` groups the CLI's flags into sub-configs (workload, engine,
pricing, placement, observability, speculative) whose field names match the
flag names 1:1 and equal the JAX package's, and ``ServeOptions.from_args``
builds the tree from a parsed ``argparse`` namespace.  ``validate()`` raises
``ValueError`` on exactly the flag interactions the JAX package's does
(every one that would silently do nothing).

``serve`` runs on the card unless the caller passes ``device="cpu"``.  On
the card the paged layout's decode attention is the hand-written kernel
(``paged_attention_impl="hopper"``, the counterpart of the JAX package's
``"pallas"``) and each engine step replays a CUDA graph; on the CPU the
plain versions run eagerly.  The dense layout's attention and the static
server are plain PyTorch ops, as they are XLA ops in the JAX package.
Every decoder-only config of the registry serves: the MoE and recurrent
families too (their states ride the slot engines), windowed configs
(mixtral, recurrentgemma) on the dense layout.

Phase placement and disaggregation run as in the JAX package:
``--placement auto`` prices the two serving phases over the placement
engines and runs the winning pair, ``--placement disagg`` (or an engine
flag) runs the disaggregated loop, whose prefill and decode slot engines
each replay their own CUDA graph on a card and hand each request's slot
over exactly; ``--device-assignment auto`` places the phases on distinct
cards where two are visible, ``--measure-link-bw`` measures the copy rate
between them into the profile cache.

Speculative decoding rides the same path: ``speculative.speculate=True``
asks the trade-off analyzer (`placement.choose_speculation`) to price a
draft model against plain decode at the measured-or-prior acceptance rate
and only engages speculation when it wins; ``draft_k`` forces a depth
regardless.  Colocated or disaggregated, the draft's steps run the
paged-attention kernel and the target verifies k+1 positions per round.
When the draft is the target (the default draft is qwen2_1_5b, seed 0),
the draft shares the target engine's weights.

Observability rides it too: ``--trace``, ``--metrics-out`` and
``--slo-report``; ``--watchdog`` (with ``--drift-gate`` and the injected
``--misprice``) re-prices admission mid-run when the observed step cost
drifts from the price; ``--feed-cache`` flushes the run's burst timings
(and a speculating run's measured acceptance) into the profile cache, and
``--persist-curves`` primes the next run's pricing from the latency curve
fitted to them.  These three time every burst with a sync, colocated or
disaggregated, speculating or not.  On the disaggregated loop a drift alert
also re-runs phase placement with the drifted device de-rated; with
distinct prefill and decode engines the decision actuates, moving the
decode phase onto the other engine and live-migrating in-flight slots
(``--misprice-phase`` scopes the injected error to one phase's device
model).

Options whose modules are not ported yet pass ``validate()`` as they do in
the JAX package and then raise ``NotImplementedError`` in ``serve``, naming
the ROADMAP item that ports them: the production meshes (§1 item 9).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import registry
from ..core.engines import ENGINES_BY_NAME
from ..launch.mesh import device_assignment
from ..models import transformer as T
from ..obs import (AcceptanceTracker, Observability, PerfWatchdog,
                   TelemetryFeedback, Tracer, default_clock,
                   format_slo_report, slo_attainment, write_metrics,
                   write_trace)
from ..profiling.bench import dtype_name
from . import placement as placement_lib
from .disagg import DisaggregatedEngineLoop
from .engine_loop import EngineLoop
from .request import prefix_shared_workload, synthetic_workload
from .speculative import (DEFAULT_ACCEPTANCE_PRIOR, SpecPlan,
                          SpeculativeEngineLoop, validate_speculation)

# defaults applied at serve() time for options whose parser default is None
# so validate() can tell "user set it" from "left alone"; the JAX package's,
# with the port's measured engine in place of its "xla"
EFFECTIVE_DEFAULTS = {
    "shared_frac": 0.9,
    "calibrated_engine": "torch",
    "misprice_phase": "both",
    "slo_ttft_ms": 2000.0,
    "slo_tpot_ms": 200.0,
    "draft_arch": "qwen2_1_5b",
}


# ---------------------------------------------------------------------------
# Options tree (field names == CLI flag names, dashes -> underscores)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WorkloadOptions:
    """What traffic to serve."""
    arch: str = "qwen2_1_5b"
    scale: str = "smoke"
    requests: int = 8
    prompt_len: int = 32
    gen_len: int = 32
    rate: float = 16.0
    shared_prefix_len: Optional[int] = None
    shared_frac: Optional[float] = None          # effective 0.9


@dataclasses.dataclass
class EngineOptions:
    """How the serving engine runs and lays out KV."""
    mesh: str = "host"
    static_batching: bool = False
    batch: int = 4                               # static path only
    slots: int = 8
    kv_layout: str = "paged"
    total_blocks: Optional[int] = None
    prefix_sharing: bool = False
    stream: bool = False


@dataclasses.dataclass
class PricingOptions:
    """Which device model prices admission."""
    step_slo_ms: Optional[float] = None
    device_model: str = "nvidia-h100"
    calibrated_cache: Optional[str] = None
    calibrated_engine: Optional[str] = None      # effective "torch"


@dataclasses.dataclass
class PlacementOptions:
    """Phase placement + disaggregation."""
    placement: str = "colocated"
    placement_objective: str = "latency"
    prefill_engine: Optional[str] = None
    decode_engine: Optional[str] = None
    prefill_slots: Optional[int] = None
    device_assignment: str = "single"
    sync_handoff: bool = False
    handoff_link_bw: Optional[float] = None
    measure_link_bw: Any = None                  # True | path | None


@dataclasses.dataclass
class ObservabilityOptions:
    """Tracing, metrics, telemetry feedback, watchdog, SLO reporting."""
    trace: Optional[str] = None
    metrics_out: Optional[str] = None
    feed_cache: Any = None                       # True | path | None
    persist_curves: Optional[str] = None
    watchdog: bool = False
    drift_gate: Optional[float] = None
    misprice: Optional[float] = None
    misprice_phase: Optional[str] = None         # effective "both"
    slo_report: bool = False
    slo_ttft_ms: Optional[float] = None          # effective 2000.0
    slo_tpot_ms: Optional[float] = None          # effective 200.0


@dataclasses.dataclass
class SpeculativeOptions:
    """Draft-model speculative decoding on the decode phase."""
    speculate: bool = False
    draft_arch: Optional[str] = None             # effective qwen2_1_5b
    draft_k: Optional[int] = None                # None -> analyzer picks


@dataclasses.dataclass
class ServeOptions:
    """Typed configuration for one serving run (1:1 with the serve CLI)."""
    workload: WorkloadOptions = dataclasses.field(
        default_factory=WorkloadOptions)
    engine: EngineOptions = dataclasses.field(default_factory=EngineOptions)
    pricing: PricingOptions = dataclasses.field(
        default_factory=PricingOptions)
    placement: PlacementOptions = dataclasses.field(
        default_factory=PlacementOptions)
    observability: ObservabilityOptions = dataclasses.field(
        default_factory=ObservabilityOptions)
    speculative: SpeculativeOptions = dataclasses.field(
        default_factory=SpeculativeOptions)

    @classmethod
    def groups(cls) -> Tuple[Tuple[str, type], ...]:
        return tuple((f.name, f.type) if isinstance(f.type, type)
                     else (f.name, f.default_factory)
                     for f in dataclasses.fields(cls))

    @classmethod
    def flat_fields(cls) -> Dict[str, str]:
        """Leaf option name -> owning group, for the CLI 1:1 gate."""
        out: Dict[str, str] = {}
        for gname, gcls in cls.groups():
            for f in dataclasses.fields(gcls):
                if f.name in out:
                    raise AssertionError(
                        f"option {f.name!r} appears in both "
                        f"{out[f.name]!r} and {gname!r}")
                out[f.name] = gname
        return out

    @classmethod
    def from_args(cls, args) -> "ServeOptions":
        """Build the options tree from a parsed argparse namespace whose
        dests match the leaf field names (what build_parser produces)."""
        kwargs = {}
        for gname, gcls in cls.groups():
            kwargs[gname] = gcls(**{f.name: getattr(args, f.name)
                                    for f in dataclasses.fields(gcls)})
        return cls(**kwargs)

    @property
    def disagg_requested(self) -> bool:
        pl = self.placement
        return (pl.placement in ("disagg", "auto")
                or bool(pl.prefill_engine) or bool(pl.decode_engine))

    def validate(self) -> "ServeOptions":
        """Raise ValueError on contradictory or silently-no-op options."""
        w, e, p = self.workload, self.engine, self.pricing
        pl, o, s = self.placement, self.observability, self.speculative
        if pl.placement == "auto" and (pl.prefill_engine
                                       or pl.decode_engine):
            raise ValueError(
                "--placement auto chooses the engines; drop "
                "--prefill-engine/--decode-engine or use --placement disagg")
        if e.stream and e.static_batching:
            raise ValueError(
                "--stream needs the continuous engine (the static server "
                "only surfaces tokens at batch end)")
        if e.static_batching and (o.trace or o.metrics_out or o.feed_cache
                                  or o.watchdog or o.slo_report):
            raise ValueError(
                "--trace/--metrics-out/--feed-cache/--watchdog/--slo-report "
                "instrument the continuous engine; drop --static-batching")
        if e.static_batching and (pl.device_assignment != "single"
                                  or pl.sync_handoff or o.persist_curves
                                  or pl.measure_link_bw):
            raise ValueError(
                "--device-assignment/--sync-handoff/--persist-curves/"
                "--measure-link-bw drive the continuous engine; drop "
                "--static-batching")
        if e.prefix_sharing and e.kv_layout == "dense":
            raise ValueError("--prefix-sharing maps physical KV pages; it "
                             "requires --kv-layout paged")
        if e.prefix_sharing and e.static_batching:
            raise ValueError(
                "--prefix-sharing needs the continuous engine's KV pool")
        if w.shared_prefix_len is not None and w.shared_prefix_len <= 0:
            raise ValueError("--shared-prefix-len must be > 0")
        if w.shared_frac is not None and w.shared_prefix_len is None:
            raise ValueError(
                "--shared-frac sizes the --shared-prefix-len workload and "
                "does nothing without it; set both or neither")
        if o.misprice is not None and o.misprice <= 0:
            raise ValueError("--misprice must be > 0")
        if o.misprice_phase is not None and o.misprice is None:
            raise ValueError("--misprice-phase scopes --misprice and does "
                             "nothing without it; add --misprice FACTOR")
        if ((o.misprice is not None or o.drift_gate is not None)
                and not o.watchdog):
            raise ValueError(
                "--misprice/--drift-gate configure the watchdog and do "
                "nothing without it; add --watchdog")
        if ((o.slo_ttft_ms is not None or o.slo_tpot_ms is not None)
                and not o.slo_report):
            raise ValueError(
                "--slo-ttft-ms/--slo-tpot-ms set --slo-report objectives "
                "and do nothing without it; add --slo-report")
        if p.calibrated_engine is not None and p.calibrated_cache is None:
            raise ValueError(
                "--calibrated-engine picks measurements out of "
                "--calibrated-cache and does nothing without it; pass the "
                "cache path too")
        if not self.disagg_requested:
            if pl.sync_handoff:
                raise ValueError(
                    "--sync-handoff tunes the disaggregated hand-off; "
                    "request --placement disagg/auto")
            if pl.prefill_slots is not None:
                raise ValueError(
                    "--prefill-slots sizes the disaggregated prefill pool; "
                    "request --placement disagg/auto")
            if pl.handoff_link_bw is not None:
                raise ValueError(
                    "--handoff-link-bw prices the disaggregated hand-off; "
                    "request --placement disagg/auto")
        if s.speculate:
            if e.static_batching:
                raise ValueError("--speculate drives the continuous "
                                 "engine's paged decode; drop "
                                 "--static-batching")
            if e.prefix_sharing:
                raise ValueError(
                    "--speculate is incompatible with --prefix-sharing "
                    "(rejected verify windows must never land in "
                    "refcounted shared pages)")
            if e.kv_layout == "dense":
                raise ValueError("--speculate verifies against the paged "
                                 "KV arena; it requires --kv-layout paged")
        elif s.draft_arch is not None or s.draft_k is not None:
            raise ValueError("--draft-arch/--draft-k configure speculation "
                             "and do nothing without it; add --speculate")
        if s.draft_k is not None and s.draft_k < 1:
            raise ValueError("--draft-k must be >= 1")
        return self


def refuse_unported(options: ServeOptions) -> None:
    """Raise NotImplementedError for a valid option whose module the port
    does not have yet, naming the ROADMAP §1 item that ports it."""
    mesh = options.engine.mesh
    if mesh != "host":
        raise NotImplementedError(
            f"--mesh {mesh}: not ported yet; ROADMAP §1 item 9 (sharding) "
            f"ports it")


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeReport:
    """What one serving run produced and measured."""
    summary: Dict[str, Any]
    metrics: Any = None                  # ServeMetrics (continuous path)
    requests: List[Any] = dataclasses.field(default_factory=list)
    pool_stats: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    admission: List[Dict] = dataclasses.field(default_factory=list)
    handoff: Optional[Dict] = None
    watchdog: Optional[Dict] = None
    slo: Optional[List] = None
    placement: Optional[Dict] = None
    decode_target: Optional[str] = None
    speculation: Optional[Dict] = None
    static_tokens: Optional[List] = None

    @property
    def outputs(self) -> Dict[int, Any]:
        """rid -> generated token list (continuous path)."""
        return {r.rid: r.output for r in self.requests}


# ---------------------------------------------------------------------------
# Building blocks shared with the CLI
# ---------------------------------------------------------------------------
class Server:
    """Legacy static-batching server (the continuous engine's baseline):
    the whole batch steps through :func:`transformer.decode_step` at one
    position, and the queue refills only between generations."""

    def __init__(self, cfg: T.ModelConfig, params, max_len: int, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = T.compute_params(
            T.map_params(lambda _, t: t.to(self.device), params), cfg)
        self.max_len = max_len

    def generate(self, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
        """prompts: (B, P) int.  Returns (B, gen_len) int32 on the device."""
        b, plen = prompts.shape
        # replay the prompt into a max_len cache through decode steps (the
        # cache layout of the continuous engine's dense slots)
        cache = T.init_cache(self.cfg, b, max_seq=self.max_len,
                             device=self.device)
        with torch.no_grad():
            for i in range(plen):
                step_logits, cache = T.decode_step(
                    self.params, self.cfg, cache, prompts[:, i:i + 1])
            out = [torch.argmax(step_logits[:, -1], dim=-1)[:, None]]
            for _ in range(gen_len - 1):
                step_logits, cache = T.decode_step(self.params, self.cfg,
                                                   cache, out[-1])
                out.append(torch.argmax(step_logits[:, -1], dim=-1)[:, None])
        return torch.cat(out, dim=1).to(torch.int32)


def build_params(cfg: T.ModelConfig, device="cuda"):
    """Random weights from seed 0, drawn on ``device``."""
    return T.init_params(cfg, seed=0, device=device)


def _silent(*args, **kwargs) -> None:
    pass


def _calibrated_device(cache_path: str, engine_name: str, device, say):
    """--calibrated-cache: the device model fitted from the cache's
    measurements of ``engine_name`` under this device's environment."""
    from ..profiling import Measurement, ProfileCache, calibrate_engine
    if not os.path.exists(cache_path):
        raise ValueError(
            f"--calibrated-cache {cache_path}: no such file (run `python -m "
            f"repro_torch.launch.profile` first)")
    if engine_name not in ENGINES_BY_NAME:
        raise ValueError(f"unknown engine {engine_name!r} (choose from "
                         f"{', '.join(sorted(ENGINES_BY_NAME))})")
    cache = ProfileCache.load(cache_path, device=device)
    eng = ENGINES_BY_NAME[engine_name]
    ms = [Measurement.from_dict(d)
          for d in cache.measurements(engine=eng.name)]
    if not ms:
        n_stale = len(cache.measurements(engine=eng.name, stale=True))
        raise ValueError(
            f"{cache_path} has no measurements for engine {eng.name} under "
            f"this environment ({n_stale} from other torch versions or "
            f"devices; re-profile here or pass a matching cache)")
    model = calibrate_engine(eng, ms, register=True)
    say(f"[serve] admission priced on {model.name} "
        f"({model.n_measurements} measurements, kinds "
        f"{sorted(model.throughput)}; other kinds fall back to "
        f"{model.base_efficiency:.2f} x peak)")
    return model


def _feed_cache_path(options: ServeOptions) -> str:
    from ..profiling.cache import DEFAULT_CACHE_PATH
    o = options.observability
    return DEFAULT_CACHE_PATH if o.feed_cache is True else o.feed_cache


def _acceptance_prior(options: ServeOptions, device) -> Tuple[float, str]:
    """Acceptance rate to price speculation with: a measured rate from any
    cache this run touches (--feed-cache, --persist-curves,
    --calibrated-cache; under this device's environment), else the
    optimistic engagement prior."""
    from ..profiling.acceptance import cached_acceptance
    from ..profiling.cache import ProfileCache
    o, p, s = options.observability, options.pricing, options.speculative
    draft = s.draft_arch or EFFECTIVE_DEFAULTS["draft_arch"]
    candidates = []
    if o.feed_cache:
        candidates.append(_feed_cache_path(options))
    if o.persist_curves:
        candidates.append(o.persist_curves)
    if p.calibrated_cache:
        candidates.append(p.calibrated_cache)
    for path in candidates:
        if not os.path.exists(path):
            continue
        rate = cached_acceptance(
            ProfileCache.load(path, strict=False, device=device),
            draft_arch=draft, target_arch=options.workload.arch)
        if rate is not None:
            return rate, f"measured:{path}"
    return DEFAULT_ACCEPTANCE_PRIOR, "prior"


def _prime_curves(persist_curves: Optional[str], cfg, kv_len: int, batcher,
                  device, say: Callable) -> None:
    """--persist-curves start-up leg: fit the latency(batch) curve from the
    telemetry a previous run fed into the cache and install it as the
    decode batcher's pricing — a restarted server prices from the last
    run's observed curve instead of re-warming through the watchdog.  Only
    entries of this device's environment count."""
    if not persist_curves:
        return
    from ..obs.curves import curve_points_from_cache, fit_latency_curve
    from ..profiling.cache import ProfileCache
    if not os.path.exists(persist_curves):
        say(f"[serve] curves: {persist_curves} does not exist yet "
            f"(first run warms it)", flush=True)
        return
    cache = ProfileCache.load(persist_curves, strict=False, device=device)
    points = curve_points_from_cache(cache, cfg, kv_len=kv_len,
                                     dtype=dtype_name(cfg.compute_dtype))
    curve = fit_latency_curve(points, source="cache-curve")
    if curve is None:
        say(f"[serve] curves: {persist_curves} holds "
            f"{len(points)} usable batch point(s) — need >= 2 for a "
            f"curve; pricing stays analytic", flush=True)
        return
    detail = batcher.reprice(curve.predict, source="cache-curve")
    say(f"[serve] curves: primed {batcher.phase} pricing from "
        f"{persist_curves} (batches {list(curve.batches)}, "
        f"token budget {detail['token_budget_old']} -> "
        f"{detail['token_budget']})", flush=True)


def _serve_static(options: ServeOptions, cfg, params, device, say
                  ) -> ServeReport:
    w, e = options.workload, options.engine
    server = Server(cfg, params, w.prompt_len + w.gen_len, device=device)
    rng = np.random.default_rng(1)
    done = 0
    batches: List = []
    # monotonic clock (shared with the serving loops' timing)
    t0 = default_clock()
    while done < w.requests:
        n = min(e.batch, w.requests - done)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(n, w.prompt_len), dtype=np.int32)).to(device)
        toks = server.generate(prompts, w.gen_len).cpu().numpy()
        batches.append(toks)
        done += n
        say(f"[serve] batch of {n}: generated {toks.shape} "
            f"first row: {toks[0, :8].tolist()}", flush=True)
    dt = default_clock() - t0
    total_toks = w.requests * w.gen_len
    say(f"served {w.requests} requests, {total_toks} tokens in "
        f"{dt:.1f}s ({total_toks / dt:.1f} tok/s)")
    return ServeReport(
        summary={"requests": w.requests, "tokens": total_toks,
                 "elapsed_s": dt, "tok_per_s": total_toks / dt,
                 "static_batching": True},
        static_tokens=batches)


# ---------------------------------------------------------------------------
# serve()
# ---------------------------------------------------------------------------
def serve(options: ServeOptions, *, device="cuda", verbose: bool = False,
          on_delta: Optional[Callable] = None,
          cuda_graph: bool = True) -> ServeReport:
    """Run one serving run as configured and report what it measured.

    ``device`` defaults to the card and raises without one; ``"cpu"`` runs
    the plain versions.  ``verbose`` reproduces the CLI's progress prints;
    ``on_delta`` receives :class:`~repro_torch.serving.driver.StreamDelta`
    objects when streaming (passing one implies the per-burst sync even
    without ``options.engine.stream``).  ``cuda_graph=False`` runs the
    engine's steps eagerly on the card (the graph's yardstick).
    Configuration errors raise ``ValueError`` (``validate()`` runs first);
    options whose modules are not ported raise ``NotImplementedError``.
    """
    options.validate()
    refuse_unported(options)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    w, e, p = options.workload, options.engine, options.pricing
    o, pl, s = (options.observability, options.placement,
                options.speculative)
    say = print if verbose else _silent

    arch = registry.get(w.arch)
    cfg = arch.smoke if w.scale == "smoke" else arch.config
    if cfg is None or cfg.encoder_decoder or cfg.frontend != "none":
        raise ValueError(f"serve supports decoder-only LMs; {w.arch} "
                         f"is not one at scale {w.scale}")
    if device.type == "cuda":
        # the hand-written paged kernel; the plain gather runs in tests only
        cfg = dataclasses.replace(cfg, paged_attention_impl="hopper")
    kv_layout = e.kv_layout
    if kv_layout == "paged" and cfg.attn_window is not None:
        # the paged arena has no rolling-buffer mode (as in the JAX package)
        say(f"[serve] {w.arch} uses sliding-window attention "
            f"(window={cfg.attn_window}); paged KV layout does not "
            f"support rolling buffers yet — falling back to dense",
            flush=True)
        kv_layout = "dense"
    if e.prefix_sharing:
        if kv_layout != "paged":
            raise ValueError(f"--prefix-sharing requires the paged KV "
                             f"layout, but {w.arch} fell back to dense "
                             f"(sliding-window attention)")
        if any(t != "attn" for t in cfg.layer_types()):
            raise ValueError(f"--prefix-sharing requires an all-attention "
                             f"config; {w.arch} mixes layer types "
                             f"{sorted(set(cfg.layer_types()))} "
                             f"(recurrent/cross state is slot-local)")

    params = build_params(cfg, device)
    max_len = w.prompt_len + w.gen_len

    if e.static_batching:
        return _serve_static(options, cfg, params, device, say)

    # continuous batching: mixed-length open-loop traffic.  With
    # shared_prefix_len the stream front-loads one common prefix onto
    # shared_frac of the requests (prompts grow by the prefix, so the
    # pool's max_seq grows with them)
    gen_lens = (max(w.gen_len // 8, 1), max(w.gen_len // 2, 1), w.gen_len)
    if w.shared_prefix_len is not None:
        shared_frac = (EFFECTIVE_DEFAULTS["shared_frac"]
                       if w.shared_frac is None else w.shared_frac)
        requests = prefix_shared_workload(
            w.requests, rate=w.rate, vocab=cfg.vocab,
            shared_prefix_len=w.shared_prefix_len,
            shared_frac=shared_frac,
            suffix_lens=(max(w.prompt_len // 2, 1), w.prompt_len),
            gen_lens=gen_lens, seed=1)
        max_len += w.shared_prefix_len
    else:
        requests = synthetic_workload(
            w.requests, rate=w.rate, vocab=cfg.vocab,
            prompt_lens=(max(w.prompt_len // 2, 1), w.prompt_len),
            gen_lens=gen_lens, seed=1)
    device_model = None
    if p.calibrated_cache is not None:
        device_model = _calibrated_device(
            p.calibrated_cache,
            p.calibrated_engine or EFFECTIVE_DEFAULTS["calibrated_engine"],
            device, say)

    if on_delta is None and e.stream:
        if verbose:
            def on_delta(d):
                toks = ",".join(str(t) for t in d.tokens)
                tag = " [done]" if d.done else ""
                print(f"[stream] t={d.t:8.3f}s rid={d.rid:>4} "
                      f"+{len(d.tokens)} [{toks}]{tag}", flush=True)
        else:
            on_delta = _silent

    step_slo_s = None if p.step_slo_ms is None else p.step_slo_ms / 1e3
    calibrated_engine = (p.calibrated_engine
                         or EFFECTIVE_DEFAULTS["calibrated_engine"])

    # device topology: pin the two phase engines onto distinct cards (one
    # card is shared by both)
    assignment = None
    if pl.device_assignment == "auto":
        assignment = device_assignment(backend=device.type)
        say(f"[serve] device assignment: {assignment.summary()}",
            flush=True)

    # measured link bandwidth: a real copy of a representative page batch
    # between the phase devices, kept in the profile cache so
    # place_phases(price="measured") prices hand-offs from it later too
    measured_link_bw = None
    if pl.measure_link_bw:
        from ..profiling import record_link_bw
        from ..profiling import cache as cache_lib
        link_cache_path = (cache_lib.DEFAULT_CACHE_PATH
                           if pl.measure_link_bw is True
                           else pl.measure_link_bw)
        devs = (assignment if assignment is not None
                else device_assignment(backend=device.type))
        link_cache = cache_lib.ProfileCache.load(link_cache_path,
                                                 strict=False, device=device)
        m = record_link_bw(link_cache, devs.prefill, devs.decode)
        link_cache.save(link_cache_path)
        measured_link_bw = m["link_bw"]
        say(f"[serve] link {m['src']} -> {m['dst']}: "
            f"{measured_link_bw / 1e9:.2f} GB/s "
            f"({m['n_bytes']} bytes in {m['t_median'] * 1e3:.3f} ms) "
            f"-> {link_cache_path}", flush=True)
    handoff_link_bw = (pl.handoff_link_bw if pl.handoff_link_bw is not None
                       else measured_link_bw)

    def _engine(name: str):
        if name not in ENGINES_BY_NAME:
            raise ValueError(f"unknown engine {name!r} (choose from "
                             f"{', '.join(sorted(ENGINES_BY_NAME))})")
        return ENGINES_BY_NAME[name]

    # phase placement: which engine's device model prices each phase
    placement_report = None
    pre_eng = dec_eng = None
    if pl.placement == "auto":
        decision = placement_lib.place_phases(
            cfg, objective=pl.placement_objective,
            prompt_len=w.prompt_len, gen_len=w.gen_len, batch=e.slots,
            price="measured" if p.calibrated_cache else "analytic",
            cache_path=p.calibrated_cache, device=device)
        say(f"[serve] {decision.summary()}", flush=True)
        pre_eng = ENGINES_BY_NAME[decision.prefill_engine]
        dec_eng = ENGINES_BY_NAME[decision.decode_engine]
        placement_report = {"mode": "auto",
                            "prefill_engine": decision.prefill_engine,
                            "decode_engine": decision.decode_engine,
                            "objective": pl.placement_objective,
                            "summary": decision.summary()}
    elif options.disagg_requested:
        pre_eng = _engine(pl.prefill_engine or "torch")
        dec_eng = _engine(pl.decode_engine or "torch")
        placement_report = {"mode": "disagg",
                            "prefill_engine": pre_eng.name,
                            "decode_engine": dec_eng.name}
        for eng, phase in ((pre_eng, "prefill"), (dec_eng, "decode")):
            # a cost-only CNN engine cannot price an LM phase: ValueError
            c = placement_lib.phase_cost(
                cfg, eng, phase, prompt_len=w.prompt_len,
                gen_len=w.gen_len, batch=e.slots)
            say(f"[serve] {phase} on {eng.name}: modeled "
                f"{c.time_s*1e3:.3f}ms, {c.energy_j:.4f}J", flush=True)

    def _phase_device(eng):
        """Calibrated model when the cache covers this engine, else its own."""
        if device_model is not None and eng.name == calibrated_engine:
            return device_model
        return eng.device

    # ---- speculative decoding plan ---------------------------------------
    spec_plan = None
    spec_report = None
    if s.speculate:
        draft_arch = s.draft_arch or EFFECTIVE_DEFAULTS["draft_arch"]
        draft_reg = registry.get(draft_arch)
        draft_cfg = (draft_reg.smoke if w.scale == "smoke"
                     else draft_reg.config)
        if draft_cfg is None:
            raise ValueError(f"--draft-arch {draft_arch} is not a "
                             f"decoder-only LM at scale {w.scale}")
        if device.type == "cuda":
            draft_cfg = dataclasses.replace(draft_cfg,
                                            paged_attention_impl="hopper")
        validate_speculation(cfg, draft_cfg, kv_layout=kv_layout,
                             prefix_sharing=e.prefix_sharing)
        alpha, alpha_src = _acceptance_prior(options, device)

        def _decide(a: float):
            return placement_lib.choose_speculation(
                cfg, draft_cfg, kv_len=max_len, n_tokens=e.slots,
                acceptance=a, device_name=p.device_model,
                draft_name=draft_arch)

        decision = _decide(alpha)
        forced = s.draft_k is not None
        k = s.draft_k if forced else decision.k
        if forced or decision.use:
            # a draft that is the target shares its weights (both seed 0)
            draft_params = (params if draft_cfg == cfg
                            else build_params(draft_cfg, device))
            tracker = AcceptanceTracker(decide=None if forced else _decide)
            spec_plan = SpecPlan(draft_cfg, draft_params, k=k,
                                 draft_name=draft_arch, decision=decision,
                                 forced=forced, tracker=tracker)
            say(f"[serve] speculation: draft {draft_arch} k={k} "
                f"acceptance={alpha:.2f} ({alpha_src}) projected "
                f"x{decision.projected_speedup:.2f}"
                f"{' [forced]' if forced else ''}", flush=True)
        else:
            # the analyzer priced speculation worse than plain decode at
            # this acceptance rate — serve plain, record why
            spec_report = {"engaged": False, "priced_fallback": True,
                           "acceptance_prior": alpha,
                           "acceptance_source": alpha_src,
                           "decision": decision.summary()}
            say(f"[serve] speculation: prices worse than plain decode at "
                f"acceptance={alpha:.2f} ({alpha_src}, "
                f"x{decision.projected_speedup:.2f}) — serving plain",
                flush=True)

    def _reprice_for_speculation(batcher) -> None:
        """An engaged speculation the analyzer chose prices admission on
        its per-token cost."""
        if spec_plan is not None and spec_plan.decision.use:
            batcher.reprice(lambda n: spec_plan.decision.spec_step_s * n,
                            source="speculation")

    # one observability bundle for whichever loop runs: tracing only when
    # asked (NullTracer otherwise), the registry always (it backs the
    # hand-off ledger and the metrics dump), feedback only with feed_cache
    # or persist_curves and the watchdog only when asked (each syncs every
    # burst to time it)
    watchdog = None
    if o.watchdog:
        watchdog = (PerfWatchdog() if o.drift_gate is None
                    else PerfWatchdog(drift_gate=o.drift_gate))
    obs = Observability(
        tracer=Tracer() if o.trace else None,
        feedback=(TelemetryFeedback(cfg, kv_len=max_len, device=device,
                                    dtype=dtype_name(cfg.compute_dtype))
                  if o.feed_cache or o.persist_curves else None),
        watchdog=watchdog)

    misprice_phase = o.misprice_phase or EFFECTIVE_DEFAULTS["misprice_phase"]

    def _misprice(dev, phase=None):
        """Inject an admission-pricing error for watchdog runs: the device
        model scaled by --misprice.  ``--misprice-phase`` scopes it to one
        phase's device model on the disaggregated loop, so exactly that
        stream drifts (the trigger of placement actuation); on the colocated
        loop (``phase`` None) both phases are the one batcher's."""
        if o.misprice is None:
            return dev
        if (phase is not None and misprice_phase != "both"
                and misprice_phase != phase):
            return dev
        from ..core import device_models
        if dev is None:
            dev = device_models.get(p.device_model)
        return placement_lib.drift_scaled_device(dev, o.misprice)
    # auto placement only disaggregates when the analyzer says the split
    # wins; an explicit --placement disagg always runs the two-engine loop
    # (same-engine disagg measures the bare phase-boundary overhead)
    if pre_eng is not None and (pl.placement == "disagg"
                                or pre_eng.name != dec_eng.name):
        engine = DisaggregatedEngineLoop(
            cfg, params,
            n_prefill_slots=pl.prefill_slots or e.slots,
            n_decode_slots=e.slots, max_seq=max_len,
            kv_layout=kv_layout,
            decode_total_blocks=e.total_blocks,
            prefix_sharing=e.prefix_sharing,
            prefill_device=_misprice(_phase_device(pre_eng), "prefill"),
            decode_device=_misprice(_phase_device(dec_eng), "decode"),
            step_slo_s=step_slo_s, obs=obs,
            handoff_link_bw=handoff_link_bw,
            prefill_placement_engine_name=pre_eng.name,
            decode_placement_engine_name=dec_eng.name,
            assignment=assignment,
            async_handoff=not pl.sync_handoff, plan=spec_plan,
            device=device, cuda_graph=cuda_graph)
        spec = engine.spec
        _prime_curves(o.persist_curves, cfg, max_len, engine.decode_batcher,
                      device, say)
        _reprice_for_speculation(engine.decode_batcher)
        engine.warmup()
        metrics = engine.run(requests, on_delta=on_delta)
        for b in engine.batchers:
            say(f"[serve] {b.phase} token budget {b.token_budget}/"
                f"{b.pool.n_slots} slots (device model {b.device_name})")
        pools = (("prefill", engine.prefill.pool),
                 ("decode", engine.decode.pool))
        batchers = engine.batchers
        handoff_stats = engine.handoff.stats()
        decode_target = engine.decode_target
        for key, v in handoff_stats.items():
            val = f"{v:.4f}" if isinstance(v, float) else str(v)
            say(f"[serve] handoff.{key:>17}: {val}", flush=True)
        say(f"[serve] decode target: {engine.decode_target} engine "
            f"({'async' if not pl.sync_handoff else 'sync'} hand-off)",
            flush=True)
    else:
        if pre_eng is not None:          # colocated by choice of placement
            device_model = _phase_device(pre_eng)
        loop_kwargs = dict(
            n_slots=e.slots, max_seq=max_len, kv_layout=kv_layout,
            total_blocks=e.total_blocks, prefix_sharing=e.prefix_sharing,
            device_name=p.device_model, device_model=_misprice(device_model),
            step_slo_s=step_slo_s, obs=obs, device=device,
            cuda_graph=cuda_graph)
        if spec_plan is not None:
            engine = SpeculativeEngineLoop(cfg, params, plan=spec_plan,
                                           **loop_kwargs)
            spec = engine.spec
        else:
            engine = EngineLoop(cfg, params, **loop_kwargs)
            spec = None
        _prime_curves(o.persist_curves, cfg, max_len, engine.batcher, device,
                      say)
        _reprice_for_speculation(engine.batcher)
        engine.warmup()
        metrics = engine.run(requests, on_delta=on_delta)
        say(f"[serve] token budget {engine.batcher.token_budget}/"
            f"{e.slots} slots (device model {engine.batcher.device_name})")
        pools = (("", engine.pool),)
        batchers = (engine.batcher,)
        handoff_stats = None
        decode_target = None
    summary = metrics.summary()
    for key, v in summary.items():
        val = f"{v:.4f}" if isinstance(v, float) else str(v)
        say(f"[serve] {key:>22}: {val}", flush=True)
    # KV-pool ledger + admission accounting (end-of-run state of the block
    # ledger, plus what the batcher did to the queue over the whole run)
    pool_stats = {}
    for tag, pool in pools:
        prefix = f"kv_pool{'.' + tag if tag else ''}"
        stats = pool.stats()
        pool_stats[tag or "kv_pool"] = stats
        for key, v in stats.items():
            val = f"{v:.4f}" if isinstance(v, float) else str(v)
            say(f"[serve] {prefix}.{key:>15}: {val}", flush=True)
    admission = []
    for b in batchers:
        tag = f" [{b.phase}]" if len(batchers) > 1 else ""
        admission.append({
            "phase": b.phase, "n_admitted": b.n_admitted,
            "n_rejected": b.n_rejected, "n_deferred": b.n_deferred,
            "token_budget": b.token_budget, "n_slots": b.pool.n_slots,
            "device_model": b.device_name, "n_reprices": b.n_reprices,
            "price_source": b.price_source})
        say(f"[serve] admission{tag}: {b.n_admitted} admitted, "
            f"{b.n_rejected} rejected (deadline/oversize), "
            f"{b.n_deferred} deferrals (budget or pool pressure)",
            flush=True)

    # ---- speculation accounting ------------------------------------------
    if spec is not None:
        spec_report = dict(spec.stats())
        spec_report["engaged"] = True
        rate = spec.acceptance_rate
        say(f"[serve] speculation: {spec.n_rounds} rounds, "
            f"{spec.n_committed} committed / {spec.n_proposed} proposed "
            f"(acceptance {rate if rate is not None else float('nan'):.3f})"
            + (" [disabled mid-run: priced worse at measured acceptance]"
               if spec.disabled_midrun else ""), flush=True)

    # ---- watchdog + SLO reporting ----------------------------------------
    watchdog_report = None
    if watchdog is not None:
        watchdog_report = rep = watchdog.report()
        say(f"[serve] watchdog: {len(rep['alerts'])} drift alerts, "
            f"{len(rep['reprices'])} re-price events, sync cadence "
            f"{rep['sync_cadence']}", flush=True)
        for a in rep["alerts"]:
            say(f"[serve] watchdog.alert: {a['engine']}/{a['phase']} "
                f"{a['direction']} ewma={a['ewma_ratio']:.2f} "
                f"(priced {a['priced_step_s']*1e3:.2f}ms, observed "
                f"{a['observed_step_s']*1e3:.2f}ms)", flush=True)
        for r in rep["reprices"]:
            say(f"[serve] watchdog.reprice: {r['engine']}/{r['phase']} "
                f"pricing={r.get('pricing')} token_budget "
                f"{r.get('token_budget_old')} -> {r.get('token_budget')}",
                flush=True)
        for b in batchers:
            if b.n_reprices:
                say(f"[serve] admission [{b.phase}] re-priced "
                    f"{b.n_reprices}x ({b.price_source}); final budget "
                    f"{b.token_budget}/{b.pool.n_slots}", flush=True)
    slo_rows = None
    if o.slo_report:
        slo_ttft_ms = (EFFECTIVE_DEFAULTS["slo_ttft_ms"]
                       if o.slo_ttft_ms is None else o.slo_ttft_ms)
        slo_tpot_ms = (EFFECTIVE_DEFAULTS["slo_tpot_ms"]
                       if o.slo_tpot_ms is None else o.slo_tpot_ms)
        slo_rows = slo_attainment(requests, ttft_slo_s=slo_ttft_ms / 1e3,
                                  tpot_slo_s=slo_tpot_ms / 1e3)
        say(format_slo_report(slo_rows, ttft_slo_s=slo_ttft_ms / 1e3,
                              tpot_slo_s=slo_tpot_ms / 1e3), flush=True)
    if o.trace:
        path = write_trace(obs.tracer, o.trace)
        say(f"[serve] trace: {len(obs.tracer.events)} events "
            f"({obs.tracer.n_dropped} dropped, {obs.tracer.n_open} "
            f"unclosed) -> {path}", flush=True)
    if o.metrics_out:
        extra = {"summary": summary}
        if watchdog is not None:
            extra["watchdog"] = watchdog_report
        if spec_report is not None:
            extra["speculation"] = spec_report
        path = write_metrics(obs.registry, o.metrics_out,
                             tracer=obs.tracer if o.trace else None,
                             extra=extra)
        say(f"[serve] metrics snapshot -> {path}", flush=True)
    if o.feed_cache:
        from ..profiling.acceptance import record_acceptance
        from ..profiling.cache import ProfileCache
        cache_path = _feed_cache_path(options)
        cache = ProfileCache.load(cache_path, strict=False, device=device)
        n = obs.feedback.flush(cache)
        if spec is not None and spec.n_proposed > 0:
            # persist the measured acceptance so the next run's analyzer
            # prices on data instead of the engagement prior
            record_acceptance(cache, draft_arch=spec.plan.draft_name,
                              target_arch=w.arch, k=spec.plan.k,
                              n_proposed=spec.n_proposed,
                              n_accepted=spec.n_accepted,
                              n_rounds=spec.n_rounds)
            say(f"[serve] acceptance {spec.plan.draft_name} -> {w.arch}: "
                f"{spec.acceptance_rate:.3f} -> {cache_path}", flush=True)
        cache.save(cache_path)
        say(f"[serve] fed {n} telemetry measurements from "
            f"{obs.feedback.n_bursts} bursts (batch sizes "
            f"{obs.feedback.batches}) -> {cache_path}", flush=True)
    if o.persist_curves:
        # persist-curves exit leg: flush this run's burst telemetry so the
        # next serve's _prime_curves finds a fresh curve
        from ..profiling.cache import ProfileCache
        cache = ProfileCache.load(o.persist_curves, strict=False,
                                  device=device)
        n = obs.feedback.flush(cache)
        cache.save(o.persist_curves)
        say(f"[serve] curves: persisted {n} telemetry measurements "
            f"(batch sizes {obs.feedback.batches}) -> "
            f"{o.persist_curves}", flush=True)

    return ServeReport(
        summary=summary, metrics=metrics, requests=list(requests),
        pool_stats=pool_stats, admission=admission, handoff=handoff_stats,
        watchdog=watchdog_report, slo=slo_rows, placement=placement_report,
        decode_target=decode_target, speculation=spec_report)
