"""Serving CLI of the port: continuous-batching engine loop (default) or the
legacy static-batch server (``--static-batching``).

    PYTHONPATH=src python -m repro_torch.launch.serve --scale full \
        --slots 8 --requests 8 --prompt-len 128 --gen-len 32 --rate 1e9

This module is only the CLI skin: every flag maps 1:1 onto a field of
:class:`repro_torch.serving.api.ServeOptions` (the flags, dests, types,
choices and defaults of the JAX package's ``repro.launch.serve``, but
``--device-model``'s default, ``nvidia-h100``, and the extra ``--device``),
and ``main()`` does nothing but parse -> ``ServeOptions.from_args`` ->
``validate`` -> ``serve``.

It serves on the card unless ``--device cpu`` is given: there the paged
layout's attention is the hand-written kernel and each engine step replays
a CUDA graph.  ``--kv-layout dense`` keeps physically max_seq-long slot rows
(the same tokens as paged); ``--static-batching`` steps whole batches
through the dense decode step.  ``--trace``, ``--metrics-out`` and
``--slo-report`` write the Chrome trace, the metrics snapshot and the SLO
table.  ``--placement disagg`` serves on a prefill and a decode slot engine
(each its own CUDA graph on a card) with an exact slot hand-off,
``--placement auto`` lets the phase-placement analyzer pick the engines.
``--speculate`` prices draft-model speculative decoding against plain decode
and engages it where it wins (``--draft-k K`` forces depth K, ``--draft-arch``
names the draft), colocated or disaggregated; it prints the
``[serve] speculation: ...`` lines.  ``--watchdog`` (``--misprice F`` injects
a pricing error it must correct, ``--misprice-phase`` scopes it to one
phase), ``--feed-cache`` and ``--persist-curves`` serve colocated or
disaggregated and print the ``[serve] watchdog`` and ``[serve] curves``
lines; disaggregated over two distinct engines, a drift alert can move the
decode phase onto the other engine and live-migrate its slots (the
``handoff.n_live_migrations`` and ``decode target`` lines).  Flags whose
modules are not ported yet (the production meshes) exit with the ROADMAP
item that ports them.
"""
from __future__ import annotations

import argparse

# re-exported as the JAX package's CLI module does
from ..serving.api import (ServeOptions, ServeReport, Server,  # noqa: F401
                           build_params, serve)

# the JAX package's phase-placement objectives (serving/placement.py), the
# choices of --placement-objective
PLACEMENT_OBJECTIVES = ("latency", "energy", "edp", "perf_density")


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's argument parser (module-level so tests and the docs
    consistency gate can introspect the flag set without running a
    server).  Every dest matches a ServeOptions leaf field; flags whose
    absence matters to validation default to None and get their effective
    default (noted in the help) inside serve()."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4,
                    help="static path: batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--mesh", default="host", choices=["host", "pod",
                                                       "multipod"])
    ap.add_argument("--static-batching", action="store_true",
                    help="legacy fallback: static batches instead of the "
                         "continuous engine")
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous path: KV pool slots")
    ap.add_argument("--kv-layout", default="paged",
                    choices=["dense", "paged"],
                    help="continuous path: KV cache layout — paged stores "
                         "KV in fixed-size physical blocks gathered "
                         "through per-slot block tables (vLLM-style; "
                         "outputs bit-identical to dense), dense keeps "
                         "physically max_seq-long slot rows")
    ap.add_argument("--total-blocks", type=int, default=None,
                    help="paged layout: physical KV blocks to provision "
                         "(default: the dense equivalent; smaller values "
                         "provision for tokens-in-flight and admission "
                         "defers when pages run out)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="continuous path, paged layout: maintain a prefix "
                         "index over prompt-token block prefixes and map "
                         "matching prefixes onto already-written KV pages "
                         "(refcounted, copy-on-write at a divergent tail) — "
                         "shared prefixes skip prefill and draw no fresh "
                         "blocks, so more requests fit the same pool")
    ap.add_argument("--shared-prefix-len", type=int, default=None,
                    metavar="N",
                    help="workload: front-load one common N-token prefix "
                         "onto --shared-frac of the requests (the chat/"
                         "agent system-prompt pattern prefix sharing "
                         "exploits); default: fully unique prompts")
    ap.add_argument("--shared-frac", type=float, default=None,
                    help="workload: fraction of requests carrying the "
                         "--shared-prefix-len common prefix (default 0.9; "
                         "requires --shared-prefix-len)")
    ap.add_argument("--rate", type=float, default=16.0,
                    help="continuous path: offered load (req/s)")
    ap.add_argument("--stream", action="store_true",
                    help="continuous path: stream tokens incrementally — "
                         "the engine syncs at burst boundaries and prints "
                         "each request's newly readable tokens (TTFT then "
                         "measures delivered tokens; costs one host sync "
                         "per burst)")
    ap.add_argument("--step-slo-ms", type=float, default=None,
                    help="continuous path: per-step latency objective the "
                         "cost model prices admission against")
    ap.add_argument("--device-model", default="nvidia-h100",
                    help="continuous path: core/device_models entry used to "
                         "price admission")
    ap.add_argument("--calibrated-cache", default=None, metavar="PATH",
                    help="price admission on a profiling-calibrated device "
                         "model fitted from this profile cache "
                         "(repro_torch.profiling) instead of nominal "
                         "constants")
    ap.add_argument("--calibrated-engine", default=None,
                    help="engine whose measurements to calibrate from when "
                         "--calibrated-cache is given (default torch)")
    ap.add_argument("--placement", default="colocated",
                    choices=["colocated", "disagg", "auto"],
                    help="auto: price prefill/decode separately over the "
                         "placement engine set and run the winning pair; "
                         "disagg: force the "
                         "disaggregated loop on --prefill-engine/"
                         "--decode-engine")
    ap.add_argument("--placement-objective", default="latency",
                    choices=list(PLACEMENT_OBJECTIVES),
                    help="objective the phase placement minimizes")
    ap.add_argument("--prefill-engine", default=None, metavar="ENGINE",
                    help="engine (core/engines name) whose device model "
                         "prices the prefill phase (implies --placement "
                         "disagg unless auto)")
    ap.add_argument("--decode-engine", default=None, metavar="ENGINE",
                    help="engine whose device model prices the decode phase")
    ap.add_argument("--prefill-slots", type=int, default=None,
                    help="disaggregated path: prefill-engine slots "
                         "(default: --slots)")
    ap.add_argument("--device-assignment", default="single",
                    choices=["single", "auto"],
                    help="disaggregated path: auto pins the prefill and "
                         "decode engines onto distinct devices when >= 2 "
                         "are visible; single keeps everything on one "
                         "device")
    ap.add_argument("--sync-handoff", action="store_true",
                    help="disaggregated path: adopt each phase hand-off "
                         "immediately after dispatch instead of letting "
                         "the transfer overlap the prefill engine's next "
                         "bursts (the synchronous baseline the async "
                         "hand-off is measured against)")
    ap.add_argument("--handoff-link-bw", type=float, default=None,
                    metavar="BYTES_PER_S",
                    help="disaggregated path: price phase hand-offs at "
                         "this link bandwidth instead of the device "
                         "models' datasheet fallback (wins over "
                         "--measure-link-bw)")
    ap.add_argument("--measure-link-bw", nargs="?", default=None,
                    const=True, metavar="PATH",
                    help="measure an actual inter-device copy "
                         "of a representative page batch between the two "
                         "phase devices at startup, record it in the "
                         "profile cache for measured placement, and "
                         "price this run's hand-offs with it")
    ap.add_argument("--persist-curves", default=None, metavar="PATH",
                    help="continuous path: prime admission pricing from "
                         "the latency(batch) curve a previous run fed "
                         "into this profile cache (source="
                         "serving-telemetry), and flush this run's burst "
                         "telemetry back on exit — a restarted server "
                         "prices from the last run's curve instead of "
                         "re-warming")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="continuous path: record per-request lifecycle "
                         "spans + engine burst/sync spans and write a "
                         "Chrome trace-event JSON (open in Perfetto or "
                         "chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="continuous path: dump the metrics-registry "
                         "snapshot (counters, histogram summaries, sampled "
                         "KV-occupancy/queue-depth time series) as JSON")
    ap.add_argument("--feed-cache", nargs="?", default=None,
                    const=True, metavar="PATH",
                    help="continuous path: feed observed decode-burst step "
                         "timings back into the profiling cache as measured "
                         "points (default path: the REPRO_TORCH_PROFILE_CACHE "
                         "profile cache), so price=\"measured\" learns from "
                         "this run's traffic; with --speculate also "
                         "persists the measured acceptance rate the "
                         "analyzer prices later runs on")
    ap.add_argument("--watchdog", action="store_true",
                    help="continuous path: run the online performance "
                         "watchdog — compare observed burst step times "
                         "against the priced cost model, fit latency(batch) "
                         "curves from telemetry, and re-price admission "
                         "mid-run when the EWMA divergence crosses the gate")
    ap.add_argument("--drift-gate", type=float, default=None,
                    help="watchdog: observed/priced EWMA ratio (or its "
                         "inverse) that raises a DriftAlert (default 1.5; "
                         "requires --watchdog)")
    ap.add_argument("--misprice", type=float, default=None, metavar="FACTOR",
                    help="debug/CI: scale the admission device model's "
                         "throughput down by FACTOR (drift_scaled_device) "
                         "so the priced step time is FACTOR x too slow — "
                         "an injected mispricing the watchdog must detect "
                         "and correct (FACTOR < 1 prices too FAST, so the "
                         "drifted device looks slow and placement moves "
                         "work off it; requires --watchdog)")
    ap.add_argument("--misprice-phase", default=None,
                    choices=["both", "prefill", "decode"],
                    help="--misprice scope on the disaggregated path: "
                         "misprice only one phase's device model so "
                         "exactly that stream drifts (the deterministic "
                         "trigger for mid-run placement actuation; "
                         "default both, requires --misprice)")
    ap.add_argument("--slo-report", action="store_true",
                    help="continuous path: print per-request-class "
                         "(short/medium/long by generation length) "
                         "TTFT/TPOT SLO attainment after the run")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="--slo-report: time-to-first-token objective "
                         "(ms, default 2000; requires --slo-report)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="--slo-report: time-per-output-token objective "
                         "(ms, default 200; requires --slo-report)")
    ap.add_argument("--speculate", action="store_true",
                    help="continuous path, paged layout: draft-model "
                         "speculative decoding — the draft proposes k "
                         "tokens per slot, the target verifies all k in "
                         "one multi-position step over the paged cache "
                         "(greedy outputs stay bit-identical to plain "
                         "decode); the trade-off analyzer prices the "
                         "draft and depth against plain decode at the "
                         "measured-or-prior acceptance rate and serves "
                         "plain when speculation prices worse")
    ap.add_argument("--draft-arch", default=None, metavar="ARCH",
                    help="--speculate: registry arch proposing draft "
                         "tokens (default qwen2_1_5b; must share the "
                         "target's vocab)")
    ap.add_argument("--draft-k", type=int, default=None, metavar="K",
                    help="--speculate: force draft depth K and skip the "
                         "analyzer's engage/veto pricing (the CI and "
                         "bit-identity knob)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve: cuda (default; the paged kernel "
                         "and the graph-replayed step) or cpu (the plain "
                         "versions, eagerly)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    options = ServeOptions.from_args(args)
    try:
        options.validate()
    except ValueError as err:
        ap.error(str(err))
    try:
        serve(options, device=args.device, verbose=True)
    except (ValueError, NotImplementedError) as err:
        raise SystemExit(f"[serve] {err}")


if __name__ == "__main__":
    main()
