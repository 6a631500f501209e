#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on an NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on a failed check:

1. device  — a CUDA card of compute capability 9.0; prints its name and
             power limit as nvidia-smi reports them.
2. build   — compiles the kernels from src/repro_torch/kernels/csrc/ with
             nvcc into build/repro_torch_kernels/.
3. kernels — holds each hand-written kernel against its plain PyTorch
             version on the card, at every AlexNet layer shape at the
             serving batch, at the edge shapes of tests/test_kernels.py,
             at a matmul ragged in every dimension (3 x 9217 x 130), at
             LRN's even windows (n 4 and 2), a max pool over NaN taps (the
             NaNs must sit where the plain version's do; the error is taken
             over the other outputs), and pool and LRN cases whose C is no
             multiple of 8 or whose pointer is off 16 bytes; checks
             that two matmuls at FC6's shape are bitwise equal (split-K
             sums in a fixed order); prints the error, the kernel's median
             time (CUDA events, warm L2, after warm-up), the plain version's
             and one PyTorch library call's times, the kernel's and the
             library call's device times (device_ms: the calls queued
             behind a sleep on the card, so the host's time to issue them
             is left out), and the least time the card could take (bytes
             over 3.35 TB/s or operations over the dtype's peak, the larger;
             fp32 matmul and conv2d at the 3xTF32 rate, see peak; a
             convolution counts the operations of the cheapest of direct,
             Winograd and FFT, see conv_ops).  At AlexNet's shapes no
             measured time may be below that bound; where bytes bound the
             work, the times with the L2 flushed before each call
             (cold_device_ms, plain_cold_ms, library_cold_device_ms; a
             256 MB write between calls) are held to it as well, since a
             warm call may read an input that fits the 50 MB L2 from it.
             Prints each kernel's own kernels at every AlexNet layer
             beside the library call's (torch.profiler), conv2d's device
             ms by layer group beside F.conv2d's, and Pool1/2/5's under
             three tilings of the pool kernel (pool_tilings).
4. main    — serves 4 batches of 64 images through the full-width AlexNet
             (random weights from a numpy seed, carried in with
             params_from_numpy) under three plans: the default schedule,
             the kernel engine alone, and PyTorch's operators alone.  Checks
             the launch counts; that every layer's output of the first two
             plans agrees with the PyTorch plan's (LAYER_RTOL of the layer's
             largest magnitude, log-probabilities within LOGP_ATOL); that
             the probabilities agree at the looser tolerance of the JAX
             package's engine-agreement test; and that rows sum to 1.
             Prints images/s.
4b. measured — the paper's profile-then-offload at batch 64 in fp32:
             times every AlexNet layer on the torch and hopper engines
             (repro_torch.profiling, CUDA events around each call, a cache
             under build/), re-prices the default plan from the cache
             (compile_plan(price="measured")), which must equal
             schedule(price="measured") and put each layer on the engine
             of the smaller median; runs it, checks its launch counts and
             holds its layers and probabilities to the PyTorch plan's as
             phase 4 does.  Prints the measured plan's engine per layer,
             its images/s beside the three plans of phase 4 (in turns,
             median of three rounds), each engine's analytic and
             calibrated MAPE, and bench_torch_paper.py's Figs. 7-8 part 2
             (FC6-8 at 16 rows, cuBLAS against the matmul kernel, which
             must agree) and Table III rows (every kernel's shared memory
             per block, each within 232,448 B).
5. lm-kernels — holds the paged- and flash-attention kernels against their
             plain versions in bf16 at qwen2-1.5B's head shapes (12 query
             heads, 2 kv heads, head_dim 128): the serve phase's decode
             shape, 8 slots at positions spread over 0..2047 (pages of 16,
             a boundary page, an inactive slot) and 8 slots on the paged
             kernel's split boundaries with one at pos < 0 (written as
             zeros, as the Pallas kernel writes it, where the plain version
             averages); checks that the serve shape's slot at position 90
             gives the same bits alone, in the serve batch and in the
             8 x 2048 batch; and prefill at batch 1-4, 512 and 2048 tokens,
             and flash's edge cases: ragged S = T = 300, S = 37 against
             T = 100 (query ends aligned, and starts aligned: q_offset 0),
             a window of 64, head_dim 64, and an fp32 case (the CUDA-core
             body), and phase 13's unmasked calls (causal=False): S = T =
             512 at seamless's heads (16 over 16, D 64), S = 512 against a
             ragged T = 6404 at llama-vision's (64 over 8, D 128), and
             S = 37 against T = 100, and at head dim 16 (6 over 2 heads,
             S = 37 against T = 100), on inputs that make every key tile
             count (sensitize: peaked rows, the last 4 keys each carrying
             a few rows, rows whose every key sits far below a zero
             logit), each held within SENSITIZED_REL of its plain output's
             largest magnitude, and that limit checked to fail the plain
             version run without the last 4 keys, without the first key
             tile, and (T ragged) over zero keys up to the next tile;
             the head dims the SMOKE configs (16) and recurrentgemma-2b
             (256) give the kernel: D 16 causal and ragged (6 over 2
             heads, S = T = 300), D 256 at recurrentgemma's attention (10
             over 1 head, S = T = 4096, a window of 2048 that bites), both
             on inputs that hold the mask's edges to account (plant_edges:
             peaked rows, a few rows each with its key just inside and
             just outside an edge of its mask at a large logit), held
             within SENSITIZED_REL as the unmasked ones, with that limit
             checked to fail the plain version with the causal edge one
             key later or earlier, the window one key or one tile wider
             or narrower, or without key tile 1 or the ragged last tile,
             and the fp32 body at each (D 256 with a window of 64);
             times each beside its plain version,
             a library yardstick (index_select gather + SDPA for paged,
             SDPA on repeated KV heads for flash, with an explicit mask
             where its is_causal would align query starts, none where
             nothing is masked) and its bound.
6. prefill — forward() of the full-width qwen2-1.5B (28 layers, random
             weights from a seed, bf16 compute) on one 512-token prompt
             with attention_impl "hopper": the flash kernel must launch once
             per layer, and the logits must agree with the same port's
             "chunked" impl within PREFILL_RTOL of their largest magnitude.
             Prints ms per forward.
7. serve   — EngineLoop.run of 8 requests (prompt 128, 32 new tokens,
             8 slots, pages of 16) on the same model with the paged kernel,
             each step a replay of the engine's CUDA graph (captured by
             warmup() before the counts are set to 0); the paged kernel
             must launch once per layer and step, counted through the
             replays, and every request must finish.  Holds one decode
             step's logits against the "ref" impl (DECODE_RTOL), serves the
             same requests with "ref" as well and reports tok/s, TTFT p50
             and the greedy-token agreement of the two runs (reported, not
             gated: the kernel is close to the plain version, not bitwise
             equal).  Under "ref", the JAX package's own impl, the dense
             layout's greedy tokens must equal the paged layout's bit for
             bit, and forced speculation's (self-draft) must equal plain
             decode's bit for bit at 8 slots x k 2 and at 32 slots x k 4
             (the verify is k+1 plain steps, so every product holds the
             plain step's rows); a row-count probe of qwen2's
             products is printed beside each, and where the tokens differ,
             spec_divergence names the first layer whose output bits differ
             before the check fails (spec_vs_plain).
8. serve-entry — repro_torch.serving.api.serve(), the entry point behind
             `python -m repro_torch.launch.serve`, on the full-width model
             (scale "full": all 28 layers, weights from seed 0), 8 requests
             of the serve CLI's mixed workload (prompts 64 or 128, 4-32 new
             tokens), 8 slots, rate 1e9.  The paged layout with the graph
             must launch the paged kernel (steps + the one eager warm-up
             step) x 28 times and nothing else, finish every request and
             give the eager step's tokens bit for bit; one decode step's
             logits and state after a graph replay must equal an eager
             step's from the same state.  The dense layout and the static
             server must finish all 8 requests, and a --trace file must
             pass benchmarks/check_regression.py's validate_trace.  Under
             "ref", the JAX package's impl, the static server's tokens
             (the requests in batches of one prompt length, padded to the
             8 slots' rows) must equal the continuous engine's, and a
             shared-prefix workload (8 requests over 4 slots, so that later
             requests map live donors' prefix pages) must give the same
             tokens with and without prefix sharing, bit for bit
             (serving_identities).  Prints
             tok/s and TTFT p50 of the graph, eager, dense and static runs,
             in turns, median of three.
9. placement — serve() with phase placement on the same model and
             workload: --placement disagg on the torch engine for both
             phases with --prefill-slots equal to --slots (a prefill and a
             decode slot engine, each replaying its own graph around the
             paged kernel), with the asynchronous hand-off and with
             --sync-handoff.  Both must give the colocated run's tokens bit
             for bit; the counted run must hand off every request, move
             exactly the bytes of its snapshots, and launch the paged
             kernel (prefill steps + decode steps + 2 warm-up steps) x 28
             times and nothing else.  --device-assignment auto (one card:
             shared, the hand-off copied on a side stream) with
             --measure-link-bw must keep the tokens and record the
             same-card copy rate; --placement auto prints its decision and
             keeps the tokens; a --trace of a disagg run must pass
             validate_trace with its hand-off spans.  Prints the hand-off's
             bytes, stall_s and overlap_s, whether 2 prefill slots against
             8 keep the tokens (not gated), and tok/s and TTFT p50 of
             colocated, disagg-async and disagg-sync, in turns, median of
             three, each beside the card's name and power limit.
10. speculation — serve() with draft-model speculative decoding on the
             same model and workload, the draft the target itself (the
             default draft, seed 0, sharing the target's weights):
             --speculate --draft-k 2 with the graphs (the draft's k+1 steps
             and the verify step each a CUDA graph) and eagerly, then
             --speculate alone.  Every request must finish; the graph run's
             tokens must equal the eager run's bit for bit; the priced run
             must fall back to plain decoding (priced_fallback) with the
             plain run's tokens bit for bit; the counted run must launch
             the paged kernel 28 x (plain-step replays + (k+1) x (rounds +
             the draft's warm-up round) + (k+1) x (rounds + the verify's
             warm-up call) + the one warm-up step) times and nothing else
             (the verify is k+1 plain steps), and leave every page of the
             pool free; the forced run's tokens must equal the plain run's
             bit for bit.  From a live mid-decode
             state, the verify step's logits at each window offset must
             agree with k+1 sequential plain steps of the ref impl within
             DECODE_RTOL, and a round whose proposals are rejected at offset
             1 must commit 2 tokens per slot.  Prints the acceptance rate,
             rounds, committed tokens per round, the priced decision's
             table and tok/s of plain, spec-graph
             and spec-eager, in turns, median of three, beside the card's
             name and power limit.

11. families — the MoE and recurrent families.  phi3.5-MoE at full width,
             8 of its 32 layers (PHI_LAYERS; random weights from seed 0,
             bf16 compute): phase 6's prefill on the flash kernel (head dim
             128, GQA group 4) against "chunked", phase 7's serving on the
             paged kernel (launch count, one decode step against "ref",
             paged == dense under "ref" bitwise), graph == eager bitwise,
             tok/s and TTFT p50, one replayed step's device time split into
             the expert products (timed alone at the step's shape), the paged
             kernel and the rest, and peak memory; phase 5 holds both kernels
             at its head shapes ("phi-" cases).  falcon-mamba-7b (64 layers)
             and recurrentgemma-2b (26 layers) at full scale: one forward of
             two scan chunks (falcon), then serve() with phase 8's workload,
             its weights built once: falcon on the paged layout (graph and
             eager) and the dense layout, recurrentgemma (windowed) on the
             dense layout (graph and eager) after phase 6's prefill of 512
             tokens on the flash kernel (its 8 attention layers at head dim
             256, a window of 2048; logits within PREFILL_RTOL of
             "chunked"), every run's tokens bitwise equal
             to the first's; tok/s and peak memory.  The flash and paged
             launches of the phase must both be above 0.

12. train — training on the card (no hand-written kernel trains: the
             JAX package trains with its plain "chunked" attention, whose
             backward is lax, and its flash kernel has no VJP).
             qwen2-1.5B at full width and depth (fp32 masters, bf16
             compute, "chunked" attention, AdamW on the cosine schedule at
             3e-3, SyntheticLM batches of 8 x 128): 10 train steps, 2 more
             with int8 gradient compression and 1 with grad_accum 4; every
             loss and gradient norm finite, every parameter leaf moved, the
             leaves on the card; prints ms per step (median of the last 8
             of the 10, synchronized), tokens/s and peak memory beside the
             card's name and power limit.  ChunkedAttention's dq, dk and dv
             at qwen2's heads (12 over 2, D 128, S 512, key chunks of 128,
             fp32, causal, and with a window of 96) within 2e-4 of the
             largest magnitude of dot attention's autograd gradients, and
             the same unmasked against 300 keys (S != T, a short last
             chunk: the encoder's and the cross-attention's call).  At
             full width cut to 2 layers, 6 straight steps against 3 + save
             + restore into a fresh state + 3: every parameter and moment
             bitwise equal.  The JAX package's tiny config (2 layers, d 64,
             vocab 64) on bigram data, 150 steps at cosine 1e-2: the loss
             must fall by at least 0.8 nats.  The train CLI's own main()
             (`python -m repro_torch.launch.train --scale full`) twice on
             one checkpoint directory: 2 steps, then to step 3 with
             --grad-accum 2; step 0's loss must be the train step's, every
             loss finite, and the second run must log "[restore] resumed
             at step 1".  torch.profiler splits one step's device time,
             and the AdamW update's alone.

13. cross — the encoder-decoder and gated cross-attention, random weights
             from seed 0 in bf16.  seamless-m4t-medium at full width and
             depth (12 encoder and 12 decoder layers, d 1024, 16 heads of
             64, vocab 256,206; its tree holds count_params' 614,676,480
             parameters besides the norms): forward() of a 128-token prompt
             over a 512-frame encoder stub with "hopper" must launch flash
             36 times (12 encoder, 12 decoder self, 12 cross; unmasked but
             the decoder's self-attention) and agree with "chunked" within
             PREFILL_RTOL, each call within it of "chunked" on its inputs;
             8 requests (prompt 128, 32 new tokens, max_seq 512) through
             EngineLoop on the paged kernel, each slot's cross row encode()
             of its own 512 frames, paged launches steps x 12; graph ==
             eager, paged == dense under "ref" and the disaggregated loop
             (8 + 8 slots) == colocated bitwise, the hand-off moving its
             snapshots' bytes, each with its 1 MiB cross row; 3 train steps
             at the train CLI's defaults (chunked, 8 x 128, 128 frames,
             grad_accum 2): every loss finite, every leaf moved.
             llama-3.2-vision-90b at full width cut to VISION_LAYERS (5) of
             its 100 layers, one pattern unit (4 self-attention, 1 gated
             cross-attention layer; 6.38 B parameters), its gates set to
             VISION_GATE: a 512-token prompt over 6404 image positions
             launches flash 5 times and agrees with "chunked"; the same
             serving gates on the paged kernel (launches steps x 4).
             Prints ms per forward, tok/s, TTFT p50 and peak memory beside
             the card's name and power limit.

14. obs — the performance watchdog, latency curves and telemetry
             feedback through serve() on the full-width qwen2-1.5B with
             phase 8's workload on the paged kernel (run after phase 10,
             on its weights), every burst synced and timed: --watchdog
             --misprice F (F prices a 2-token step at 100x a 50 ms step
             SLO, so admission starts at a token budget of 1) must alert
             "fast", re-price and re-open the budget to all 8 slots;
             --feed-cache and --persist-curves on one cache under build/,
             twice: the second run must start priced from the first run's
             fitted curve ("cache-curve"); --speculate --draft-k 2 under
             --watchdog must have every round observed by the watchdog.
             Each run's tokens must equal phase 8's graph run's bit for
             bit.  serve()'s slot prefill runs no flash (its count there
             is 0), so the served prompts are also prefilled on the flash
             kernel in a run of their own, each prompt's logits held
             within PREFILL_RTOL of chunked's.  Prints the
             alerts, re-prices, the curve's points and tok/s with and
             without the watchdog, in turns, median of three.

Every main-path phase (4, 4b, 6, 7, 8, 9, 10, 11, 12, 13, 14) sets every
kernel's launch count to 0 just before it and reads them all just after
(4b's count covers its profile and its plan's run; 11 and 13 sum their
runs, each counted so; 12's must all be 0).  The
last line is {"ok": true,
"device": {...}}; the line before it holds the card's name and power limit,
and the one before that the per-kernel JSON.  For the AlexNet kernels its
times are summed over the layers a kernel runs in one forward of the kernel
plan at batch 64 and its launches are those of phase 4 (per plan under
"launches_by_plan"); for the attention kernels the times are summed over
the 28 layers of one prefill forward (flash) or one decode step of the serve
phase (paged), at the shapes those phases give them, and the launches are
those of phase 6 (flash) and 8 (paged).  "launches_by_phase" gives every
kernel's count in every main-path phase, phase 10's under "speculation",
phase 11's under "families", phase 12's under "train", phase 13's under
"cross", phase 14's serve() runs under "obs" and its flash prefill of the
served prompts under "served_prompts_prefill".
Without a card, or outside a checkout of the repository, it exits nonzero
before printing any result.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BATCH, N_BATCHES = 64, 4
FP32_PEAK, BF16_PEAK, HBM_BW = 67e12, 989e12, 3.35e12   # H100 SXM datasheet
# GEMM-shaped fp32 work (matmul, conv2d) keeps fp32 accuracy on the tensor
# cores in 3xTF32 (three TF32 products at the 495 TFLOP/s dense rate), so
# the least time the card could take counts the faster of the two routes
TF32_PEAK = 495e12
FP32_GEMM_PEAK = max(FP32_PEAK, TF32_PEAK / 3)
TOL = {"float32": 2e-4, "bfloat16": 5e-2}               # tests/test_kernels.py
# phase 5's flash cases on sensitized inputs (the unmasked ones, and the
# causal ones at D 16 and 256): the kernel's largest error over its plain
# output's largest magnitude.  A bf16 output rounds to 2^-8 of a value, so
# two roundings apart are at most ~0.8%; a plain version that drops a key
# tile, reads zero keys past T, or moves a mask edge by one key moves it by
# tens of percent (printed beside each case)
SENSITIZED_REL = 2e-2
PROB_RTOL, PROB_ATOL = 2e-3, 2e-4               # tests/test_core_cnnlab.py
LAYER_RTOL, LOGP_ATOL = 3e-5, 2e-4       # ~10x the card's 2.8e-6, 1.5e-5
# bf16 through 28 layers of random weights: the kernel impl's logits against
# the plain impl's, relative to their largest magnitude; ~2.5x the 3.9e-2
# (prefill) and 4.1e-2 (one decode step) measured on the card, the size the
# two plain prefill impls (dot, chunked) differ by as well
PREFILL_RTOL, DECODE_RTOL = 0.1, 0.1
PROMPT, GEN, SLOTS, PAGE = 128, 32, 8, 16            # the serve phase
# phase 7's forced speculation under ref (slots, k, gated): the serve
# workload's, and a wide window, 32 slots at k 4 (choose_speculation picks
# k up to 4: 160 rows, where cuBLAS rounds qwen2's MLP down projection
# otherwise from 89 rows; the verify is k+1 plain steps of 32 rows), both
# gated
SPEC_RUNS = ((SLOTS, 2, True), (32, 4, True))
# phase 8: the serve CLI's options for qwen2-1.5B at full width and depth
SERVE_ENTRY = dict(scale="full", slots=SLOTS, prompt_len=PROMPT,
                   gen_len=GEN, requests=8, rate=1e9)
CNN_KERNELS = ("matmul", "conv2d", "pool", "lrn")
KERNEL_OF = {"conv": "conv2d", "norm": "lrn", "pool": "pool", "fc": "matmul"}
PROFILE_WARMUP, PROFILE_REPEATS = 3, 15     # the measured phase's profile
GEMM_KERNELS = ("matmul", "conv2d")
PREFILL_TOKENS = 512
# phase 11: phi3.5-MoE at full width cut to 8 of its 32 layers (fp32
# weights ~42 GB and their bf16 copy ~21 GB on the 80 GB card), its
# (query, kv) heads
PHI_LAYERS, PHI_HEADS = 8, (32, 8)
# recurrentgemma-2b's attention layers: 10 query heads of 256 over 1 kv
# head, a sliding window of 2048
RG_HEADS, RG_WINDOW = (10, 1), 2048
# phase 14: the step SLO the mispriced run's admission is held to
OBS_STEP_SLO_MS = 50.0
# phase 15: requests of the serve workload's generator (its first 8 are
# phase 8's): 8 alone give the decode stream 6 bursts, 3 of them counted
# after the watchdog's first-visit skips, under its warm-up of 4, so it
# never alerts; behind 8 more the bursts stay short while they queue.  The
# decode phase's price is scaled by MIGRATION_MISPRICE
MIGRATION_REQUESTS, MIGRATION_MISPRICE = 16, 1e-6
# phase 15: the watched leg of the sync-cost pair gates drift at a ratio no
# stream reaches, so its bursts are synced and observed and nothing acts
SYNC_DRIFT_GATE = 1e9
# phase 12: the train CLI's defaults (batch 8 x seq 128), 10 steps timed;
# the flash backward at qwen2's (query, kv) heads over key chunks of 128,
# and unmasked against TRAIN_CROSS_T keys (a short last chunk)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 10
QWEN2_HEADS, TRAIN_ATTN_S, TRAIN_KV_CHUNK, TRAIN_WINDOW = (12, 2), 512, 128, 96
TRAIN_CROSS_T = 300
# phase 13: seamless-m4t-medium at full width and depth (an encoder stub of
# CROSS_FRAMES frames, a CROSS_PROMPT-token prompt; its serve runs at
# CROSS_MAX_SEQ, the length of an encoder-decoder's cross row, which holds
# encode() of the slot's CROSS_FRAMES frames), trained CROSS_TRAIN_STEPS
# steps; llama-3.2-vision at full width cut to one pattern unit (4 self-
# and 1 gated cross-attention layer: 87.7 B parameters do not fit one card),
# its gates set to VISION_GATE (the init's 0 would make the cross branch add
# nothing)
CROSS_FRAMES, CROSS_PROMPT, CROSS_MAX_SEQ, CROSS_TRAIN_STEPS = 512, 128, 512, 3
VISION_LAYERS, VISION_GATE = 5, 1.0
QUEUE_SLEEP_CYCLES = 20_000_000     # ~10 ms at the H100's 1.98 GHz boost
FLUSH_BYTES = 256 << 20             # written between calls to empty the L2
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:46",
    "conv2d": "src/repro/kernels/conv2d.py:50",
    "pool": "src/repro/kernels/pooling.py:33",
    "lrn": "src/repro/kernels/lrn.py:36",
    "paged_attention": "src/repro/kernels/paged_attention.py:90",
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps: int = 10, warmup: int = 2,
            queued: bool = False) -> float:
    """Median of per-call CUDA-event times after warm-up (L2 left warm).

    A call whose device work is shorter than the host's time to issue it
    (the wrapper's checks, allocations, the launch) leaves the card idle
    between the events, so its time is the host's.  With ``queued`` the
    calls are issued behind a sleep on the card (QUEUE_SLEEP_CYCLES, ~10 ms)
    and each interval is the device's time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def time_cold_ms(torch, fn, flush, reps: int = 10) -> float:
    """Median per-call CUDA-event time with the L2 flushed before each call:
    ``flush`` (FLUSH_BYTES, five times the L2) is written between calls, so
    a call finds its inputs in device memory.  The card is busy with that
    write while the host issues the call, so each interval is the device's
    time alone."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def kernel_times(torch, fn, reps: int = 10) -> str:
    """The device time of each kernel ``fn`` launches, in us per launch,
    with its launches per call, from torch.profiler over ``reps`` calls
    (kernels alone: no launch gaps, no host)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = re.sub(r"\(anonymous namespace\)::|^void |<.*|\(.*", "",
                      ev.key)[:48]
        parts.append(f"{name}:{ev.self_device_time_total / ev.count:.2f}us"
                     f"x{ev.count / reps:g}")
    return " ".join(parts) or "no device time seen"


def peak(dtype: str, gemm: bool = False) -> float:
    """Operations per second of the card for work of this dtype; fp32
    GEMM-shaped work at its fp32-accurate tensor-core rate."""
    if dtype != "float32":
        return BF16_PEAK
    return FP32_GEMM_PEAK if gemm else FP32_PEAK


def bound(flops: float, n_bytes: float, dtype: str, gemm: bool = False):
    t_ops = flops / peak(dtype, gemm)
    t_bytes = n_bytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def conv_ops(n, oh, ow, ic, oc, kh, kw, stride) -> int:
    """Operations of the cheapest fp32-accurate algorithm for a convolution:
    the least of direct, Winograd and FFT, the last two counted in their
    elementwise-product stage alone (their transforms left out), so that
    no implementation of the same function can do less.

    Winograd runs each stride phase of the filter (a stride-1 filter of
    t = ceil((k - p) / s) taps) with tiles of at most 8 points, the most
    that keeps fp32 accuracy: F(9 - t, t) costs 8 / (9 - t) multiplications
    per output along an axis.  FFT transforms the whole padded plane once,
    real-to-complex, and multiplies L_h * (L_w // 2 + 1) complex pairs (8
    operations each) per (image, in, out) channel triple.
    """
    def winograd_axis(k):
        taps = [len(range(p, k, stride)) for p in range(stride)]
        return sum(8 / (9 - t) if t < 8 else t for t in taps if t)

    pixels = n * oh * ow * ic * oc
    direct = 2 * pixels * kh * kw
    winograd = 2 * pixels * winograd_axis(kh) * winograd_axis(kw)
    span_h, span_w = (oh - 1) * stride + kh, (ow - 1) * stride + kw
    fft = 8 * n * ic * oc * span_h * (span_w // 2 + 1)
    return int(min(direct, winograd, fft))


def kernel_cases(torch, F, ref, kern, net, rng):
    """(kernel, label, dtype, main_path, flops, bytes, kernel_fn, plain_fn,
    library_fn, has_nan) per checked shape; main_path marks AlexNet's layers
    at the serving batch, has_nan the cases whose outputs hold NaN."""
    from repro_torch.core.engines import param_shapes

    def t(shape, dtype="float32", scale=1.0, offset=0):
        """Random values; ``offset`` elements into a larger buffer (a
        contiguous tensor whose pointer is not 16-byte aligned)."""
        size = int(np.prod(shape))
        a = torch.from_numpy((rng.standard_normal(size + offset) * scale)
                             .astype(np.float32)).cuda()
        return a.to(getattr(torch, dtype))[offset:].view(shape)

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    cases = []

    def matmul_case(label, m, k, n, dtype, main, act="none", bias=True):
        x, w = t((m, k), dtype), t((k, n), dtype, (2.0 / k) ** 0.5)
        b = t((n,), dtype, 0.1) if bias else None
        out_bytes = m * n * x.element_size()
        cases.append((
            "matmul", label, dtype, main,
            2 * m * k * n, nbytes(x, w, *([b] if bias else [])) + out_bytes,
            lambda: kern["matmul"](x, w, b, activation=act),
            lambda: ref.fc_ref(x, w, b, activation=act),
            (lambda: torch.addmm(b, x, w)) if bias else
            (lambda: torch.mm(x, w)), False))

    def conv_case(label, n, hw, ic, oc, kk, stride, pad, dtype, main):
        x = t((n, hw, hw, ic), dtype)
        w = t((oc, ic, kk, kk), dtype, (2.0 / (ic * kk * kk)) ** 0.5)
        b = t((oc,), dtype, 0.1)
        ohw = (hw + 2 * pad - kk) // stride + 1
        x_cl = x.permute(0, 3, 1, 2)          # NHWC storage = channels_last
        w_cl = w.contiguous(memory_format=torch.channels_last)
        cases.append((
            "conv2d", label, dtype, main,
            conv_ops(n, ohw, ohw, ic, oc, kk, kk, stride),
            nbytes(x, w, b) + n * ohw * ohw * oc * x.element_size(),
            lambda: kern["conv2d"](x, w, b, stride=stride, padding=pad,
                                   activation="relu"),
            lambda: ref.conv2d_ref(x, w, b, stride=stride, padding=pad,
                                   activation="relu"),
            lambda: F.conv2d(x_cl, w_cl, b, stride=stride, padding=pad),
            False))

    def pool_case(label, n, hw, c, win, stride, pool_type, dtype, main,
                  nan=False, offset=0):
        x = t((n, hw, hw, c), dtype, offset=offset)
        if nan:      # NaN taps: a window centre, an edge two windows share
            x[0, 1, 1, 0] = x[0, 2, 0, 1] = x[1, 4, 6, c - 1] = float("nan")
        ohw = (hw - win) // stride + 1
        plain = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
        lib = F.max_pool2d if pool_type == "max" else F.avg_pool2d
        cases.append((
            "pool", label, dtype, main, n * ohw * ohw * c * win * win,
            nbytes(x) + n * ohw * ohw * c * x.element_size(),
            lambda: kern["pool"](x, window=win, stride=stride,
                                 pool_type=pool_type),
            lambda: plain(x, window=win, stride=stride),
            lambda: lib(x.permute(0, 3, 1, 2), win, stride), nan))

    def lrn_case(label, shape, local, dtype, main, offset=0):
        x = t(shape, dtype, offset=offset)
        cases.append((
            "lrn", label, dtype, main, x.numel() * (2 * local + 4),
            2 * nbytes(x),
            lambda: kern["lrn"](x, local_size=local),
            lambda: ref.lrn_ref(x, local_size=local),
            lambda: F.local_response_norm(x.permute(0, 3, 1, 2), local,
                                          alpha=1e-4, beta=0.75, k=2.0),
            False))

    for spec in net:               # every AlexNet layer at the serving batch
        if spec.kind == "conv":
            h, _, ic = spec.m_i
            oc, _, kk, _ = spec.m_k
            conv_case(spec.name, BATCH, h, ic, oc, kk, spec.stride,
                      spec.padding, "float32", True)
        elif spec.kind == "norm":
            lrn_case(spec.name, (BATCH, *spec.m_i), spec.local_size,
                     "float32", True)
        elif spec.kind == "pool":
            h, _, c = spec.m_i
            pool_case(spec.name, BATCH, h, c, spec.window, spec.stride,
                      spec.pool_type, "float32", True)
        elif spec.kind == "fc":
            n_in, k_o = param_shapes(spec)["w"]
            act = "none" if spec.activation == "softmax" else spec.activation
            matmul_case(spec.name, BATCH, n_in, k_o, "float32", True, act)
    # edge shapes of tests/test_kernels.py, and one ragged in every
    # dimension with a K that no split divides (scalar loader, split-K)
    for dtype in ("float32", "bfloat16"):
        matmul_case("unaligned", 100, 300, 70, dtype, False, bias=False)
        matmul_case("fc6-row", 1, 9216, 4096, dtype, False, bias=False)
        matmul_case("ragged-3x9217", 3, 9217, 130, dtype, False)
        conv_case("conv1-reduced", 2, 12, 3, 8, 11, 4, 2, dtype, False)
        conv_case("5x5-s2", 2, 24, 3, 16, 5, 2, 2, dtype, False)
        pool_case("max-13", 2, 13, 8, 3, 2, "max", dtype, False)
        lrn_case("c7", (2, 7, 7, 7), 5, dtype, False)
    for act in ("sigmoid", "tanh"):
        matmul_case(f"epilogue-{act}", 64, 96, 48, "float32", False, act)
    pool_case("avg-13", 2, 13, 8, 3, 2, "avg", "float32", False)
    pool_case("avg-9-s3", 2, 9, 3, 3, 3, "avg", "float32", False)
    lrn_case("c16-n3", (2, 7, 7, 16), 3, "float32", False)
    # the reference's even windows and NaN-propagating max; channel counts
    # off the 16-byte vector and pointers off 16 bytes (the scalar paths)
    for dtype in ("float32", "bfloat16"):
        lrn_case("c12-n4", (2, 7, 7, 12), 4, dtype, False)
        lrn_case("c6-n2", (2, 7, 7, 6), 2, dtype, False)
        lrn_case("c96-n5-offset", (2, 7, 7, 96), 5, dtype, False, offset=1)
        pool_case("max-13-nan", 2, 13, 8, 3, 2, "max", dtype, False, nan=True)
        pool_case("max-13-c12", 2, 13, 12, 3, 2, "max", dtype, False)
        pool_case("avg-13-c7", 2, 13, 7, 3, 2, "avg", dtype, False)
        pool_case("max-27-offset", 2, 27, 16, 3, 2, "max", dtype, False,
                  offset=1)
    # the plain LRN kernel's other routes (a window wider than the vector
    # kernels', more vectors than threads) and an unstaged pool (no tile's
    # rows fit the staging budget)
    lrn_case("c16-n11", (2, 7, 7, 16), 11, "float32", False)
    lrn_case("c1100-n5", (2, 3, 3, 1100), 5, "float32", False)
    pool_case("avg-7-c4096", 2, 7, 4096, 7, 1, "avg", "float32", False)
    return cases


def compare(torch, got, want, tol: float, has_nan: bool):
    """(max_abs_err, ok) of a kernel's output against its plain version's.
    With ``has_nan`` the NaNs must sit at the same positions and the error
    is taken over the others."""
    if got.shape != want.shape:
        return float("inf"), False
    g, w = got.float(), want.float()
    if not has_nan:
        return ((g - w).abs().max().item(),
                torch.allclose(g, w, rtol=tol, atol=tol))
    keep = ~w.isnan()
    err = (g[keep] - w[keep]).abs().max().item()
    return err, (torch.equal(g.isnan(), w.isnan()) and bool(keep.any())
                 and torch.allclose(g, w, rtol=tol, atol=tol, equal_nan=True))


def phase_kernels(torch, F, ref, kern, net):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    per_kernel = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                         "library_ms": 0.0, "bound_ms": 0.0,
                         "device_ms": 0.0, "library_device_ms": 0.0,
                         "cold_device_ms": 0.0,
                         "library_cold_device_ms": 0.0,
                         "main_cases": 0, "cold_cases": 0,
                         "t_ops": 0.0, "t_bytes": 0.0}
                  for name in CNN_KERNELS}
    layer_ms = {}       # AlexNet layer -> (kernel ms, plain ms) at BATCH
    gemm_dev = {}       # AlexNet GEMM layer -> (device ms, library device ms)
    failed, profiled = [], []
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for (name, label, dtype, main, flops, n_bytes, fn, plain,
         library, has_nan) in kernel_cases(torch, F, ref, kern, net, rng):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, TOL[dtype], has_nan)
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        # the library yardstick is timed at the main path's shapes only
        lib_ms = time_ms(torch, library) if main else float("nan")
        dev_ms = time_ms(torch, fn, queued=True)
        lib_dev_ms = (time_ms(torch, library, queued=True) if main
                      else float("nan"))
        gemm = name in GEMM_KERNELS
        bound_ms, bound_by = bound(flops, n_bytes, dtype, gemm)
        # a byte bound counts device-memory bytes: where bytes bound a main
        # case its times with the L2 flushed before each call are held to
        # the bound as well (warm, an input that fits the 50 MB L2 may be
        # read from it)
        cold = main and bound_by == "bytes"
        if cold:
            cold_ms, plain_cold_ms, lib_cold_ms = (
                time_cold_ms(torch, f, flush) for f in (fn, plain, library))
        else:
            cold_ms = plain_cold_ms = lib_cold_ms = float("nan")
        print(f"[kernels] {name:<6} {label:<15} {dtype:<8} "
              f"out={tuple(got.shape)} max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
              f" device_ms={dev_ms:.4f} library_device_ms={lib_dev_ms:.4f}"
              + (f" cold_device_ms={cold_ms:.4f} plain_cold_ms="
                 f"{plain_cold_ms:.4f} library_cold_device_ms="
                 f"{lib_cold_ms:.4f}" if cold else "")
              + f" launches={kern[name].launches}", flush=True)
        if not ok:
            failed.append(f"{name} {label} {dtype}: max_abs_err {err:.3e}")
        held = (ms, plain_ms, lib_ms, dev_ms, lib_dev_ms) + (
            (cold_ms, plain_cold_ms, lib_cold_ms) if cold else ())
        if main and min(held) < bound_ms:
            times = ", ".join(f"{t:.4f}" for t in held)
            failed.append(f"{name} {label}: a time below the bound "
                          f"{bound_ms:.4f} ms ({times}): the bound counts "
                          "too much work")
        if main:
            layer_ms[label] = (ms, plain_ms)
            profiled.append((name, label, fn, library))
            if name in GEMM_KERNELS:
                gemm_dev[label] = (dev_ms, lib_dev_ms)
            agg = per_kernel[name]
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms
            agg["library_ms"] += lib_ms
            agg["bound_ms"] += bound_ms
            agg["device_ms"] += dev_ms
            agg["library_device_ms"] += lib_dev_ms
            agg["main_cases"] += 1
            if cold:
                agg["cold_cases"] += 1
                agg["cold_device_ms"] += cold_ms
                agg["library_cold_device_ms"] += lib_cold_ms
            agg["t_ops"] += flops / peak(dtype, gemm)
            agg["t_bytes"] += n_bytes / HBM_BW
    del flush
    # split-K sums its slices in a fixed order: two calls, the same bits
    x = torch.from_numpy(rng.standard_normal((BATCH, 9216)).astype(
        np.float32)).cuda()
    w = torch.from_numpy((rng.standard_normal((9216, 4096)) * 0.015).astype(
        np.float32)).cuda()
    same = torch.equal(kern["matmul"](x, w), kern["matmul"](x, w))
    print(f"[kernels] matmul FC6 shape twice: bitwise_equal={same}",
          flush=True)
    if not same:
        failed.append("matmul FC6: two calls differ")
    # where each AlexNet layer's device time goes, kernel by kernel
    for name, label, fn, library in profiled:
        print(f"[kernels] profile {name} {label}: kernel "
              f"{kernel_times(torch, fn)} | library "
              f"{kernel_times(torch, library)}", flush=True)
    failed += pool_tilings(torch, ref, net)
    # the convolutions' device time by layer group, beside F.conv2d's
    groups = {"Conv1": ["Conv1"], "Conv2": ["Conv2"],
              "Conv3-5": ["Conv3", "Conv4", "Conv5"],
              "Conv1-5": ["Conv1", "Conv2", "Conv3", "Conv4", "Conv5"]}
    print("[kernels] conv2d device ms (kernel / F.conv2d): " + ", ".join(
        f"{g}={sum(gemm_dev[n][0] for n in ls):.4f}/"
        f"{sum(gemm_dev[n][1] for n in ls):.4f}"
        for g, ls in groups.items()), flush=True)
    check(not failed, "kernel checks failed: " + "; ".join(failed))
    return per_kernel, layer_ms


def pool_tilings(torch, ref, net) -> list:
    """Pool1/2/5 (fp32, batch 64, max) on the same kernel under three
    tilings: the planned one (pooling.plan, eight blocks to an SM), whole
    input rows (the most output rows whose staged rows leave room for two
    blocks to an SM) and none (taps read from device memory).  Prints each
    one's device ms; returns the tilings whose output differs from the
    plain version's."""
    from repro_torch.kernels import _build, pooling

    rng = np.random.default_rng(1)
    stream = _build.stream(torch.device("cuda", torch.cuda.current_device()))
    ms, failed = {}, []
    for spec in net:
        if spec.kind != "pool":
            continue
        h, w, c = spec.m_i
        win, s = spec.window, spec.stride
        o = (h - win) // s + 1
        x = torch.from_numpy(rng.standard_normal((BATCH, h, w, c)).astype(
            np.float32)).cuda()
        want = ref.maxpool_ref(x, window=win, stride=s)
        out = torch.empty_like(want)
        rows = {b: ((b - 1) * s + win) * w * c * 4 for b in range(1, o + 1)}
        band = max(b for b, size in rows.items()
                   if size <= 233_472 // 2 - 1024)
        tilings = {"planned": pooling.plan(w, c, o, o, win, s, 4),
                   "whole rows": (band, o, rows[band]),
                   "unstaged": (1, o, 0)}
        for name, (band, owt, smem) in tilings.items():
            def call():
                _build.launch("repro_pool", pooling._ARGTYPES, x.data_ptr(),
                              out.data_ptr(), BATCH, h, w, c, o, o, win, s,
                              1, band, owt, smem, 0, stream)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                failed.append(f"pool {spec.name} tiling {name}: output "
                              "differs from the plain version's")
            ms.setdefault(name, []).append(
                (spec.name, band, owt, time_ms(torch, call, queued=True)))
    print("[kernels] pool tilings, device ms: " + "; ".join(
        f"{name} {sum(t for *_, t in ts):.4f} (" + ", ".join(
            f"{layer} {t:.4f} [{b}x{owt}]" for layer, b, owt, t in ts) + ")"
        for name, ts in ms.items()), flush=True)
    return failed


def numpy_params(net, rng):
    """He-normal weights and small random biases, from a numpy seed."""
    from repro_torch.core.engines import param_shapes
    out = []
    for spec in net:
        layer = {}
        for name, shape in param_shapes(spec).items():
            if name == "b":
                layer[name] = (0.01 * rng.standard_normal(shape)).astype(
                    np.float32)
            else:
                fan_in = shape[0] if spec.kind == "fc" else int(
                    np.prod(shape[1:]))
                layer[name] = (rng.standard_normal(shape)
                               * (2.0 / fan_in) ** 0.5).astype(np.float32)
        out.append(layer)
    return out


def phase_main(torch, kern, net, layer_ms):
    from repro_torch.core import engines as eng
    from repro_torch.models.alexnet import AlexNet
    from repro_torch.models.convert import params_from_numpy

    rng = np.random.default_rng(0)
    params = params_from_numpy(net, numpy_params(net, rng), device="cuda")
    images = torch.from_numpy(rng.standard_normal(
        (N_BATCHES, BATCH, *net.layers[0].m_i)).astype(np.float32)).cuda()
    plans = {
        "default": AlexNet(device="cuda", params=params),
        "hopper": AlexNet(device="cuda", params=params,
                          engines=(eng.HOPPER_ENGINE,)),
        "torch": AlexNet(device="cuda", params=params,
                         engines=(eng.TORCH_ENGINE,)),
    }
    print("[main] default plan: " + ", ".join(
        f"{a.spec.name}={a.engine}" for a in plans["default"].plan.assignments))

    probs, by_plan = {}, {}
    with torch.inference_mode():
        for model in plans.values():   # first-call costs stay out of timing
            model(images[0])
        torch.cuda.synchronize()
        for fn in kern.values():       # every count to 0 before the path
            fn.launches = 0
        for label, model in plans.items():
            before = {name: fn.launches for name, fn in kern.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probs[label] = [model(x) for x in images]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            delta = {name: fn.launches - before[name]
                     for name, fn in kern.items()}
            by_plan[label] = delta
            want = {name: 0 for name in kern}
            for a in model.plan.assignments:
                if a.engine == "hopper":
                    want[KERNEL_OF[a.spec.kind]] += N_BATCHES
            # where the time goes: the layers' own times from the kernels
            # phase against the measured time of a forward
            per_fwd = dt / N_BATCHES * 1e3
            layers = {a.spec.name: layer_ms[a.spec.name][
                0 if a.engine == "hopper" else 1]
                for a in model.plan.assignments}
            top = sorted(layers.items(), key=lambda kv: -kv[1])[:5]
            print(f"[main] plan={label} images/s={N_BATCHES * BATCH / dt:.1f}"
                  f" wall_s={dt:.4f} ms_per_forward={per_fwd:.4f} "
                  f"sum_of_layer_ms={sum(layers.values()):.4f} top_layers="
                  + ",".join(f"{n}:{t:.4f}" for n, t in top)
                  + f" launches={delta}", flush=True)
            check(delta == want, f"plan {label}: launches {delta}, "
                  f"expected {want}")
        totals = {name: fn.launches for name, fn in kern.items()}
        check(all(totals[n] for n in CNN_KERNELS),
              f"a kernel never ran on the main path: {totals}")
        # every layer of the first batch, outside the counted run
        acts = {label: model.activations(images[0])
                for label, model in plans.items()}

    for label in ("default", "hopper"):
        gate_plan(torch, net, label, acts[label], probs[label], acts["torch"],
                  probs["torch"], "main")
    check_probs(torch, net, "torch", probs["torch"])
    return totals, by_plan, params, images, plans, acts["torch"], \
        probs["torch"]


def check_probs(torch, net, label, probs) -> None:
    """Each batch's output: (BATCH, classes), finite, rows summing to 1."""
    n_cls = net.layers[-1].k_o
    for p in probs:
        check(p.shape == (BATCH, n_cls) and bool(torch.isfinite(p).all()),
              f"plan {label}: output {tuple(p.shape)} not finite "
              f"({BATCH}, {n_cls})")
        check(torch.allclose(p.sum(-1), torch.ones(BATCH, device=p.device),
                             rtol=1e-5, atol=0),
              f"plan {label}: probability rows do not sum to 1")


def gate_plan(torch, net, label, acts, probs, acts_torch, probs_torch,
              tag: str) -> None:
    """Hold a plan's outputs to the PyTorch plan's: every layer of the first
    batch within LAYER_RTOL of the layer's largest magnitude, every batch's
    log-probabilities within LOGP_ATOL and probabilities at the JAX
    package's engine-agreement tolerance."""
    check_probs(torch, net, label, probs)
    rel = {}
    for spec, a, b in zip(list(net)[:-1], acts[:-1], acts_torch[:-1]):
        check(a.shape == b.shape, f"plan {label} {spec.name}: shape "
              f"{tuple(a.shape)}, expected {tuple(b.shape)}")
        rel[spec.name] = ((a - b).abs().max() / b.abs().max()).item()
    # log-probabilities: the logits less their row's logsumexp; the clamp
    # keeps probabilities that underflow out of the comparison
    logp_diff = max(
        (torch.log(a.clamp_min(1e-30)) - torch.log(b.clamp_min(1e-30)))
        .abs().max().item() for a, b in zip(probs, probs_torch))
    prob_diff = max((a - b).abs().max().item()
                    for a, b in zip(probs, probs_torch))
    prob_ok = all(torch.allclose(a, b, rtol=PROB_RTOL, atol=PROB_ATOL)
                  for a, b in zip(probs, probs_torch))
    worst = max(rel, key=rel.get)
    print(f"[{tag}] plan={label} vs torch: layer_rel_err="
          + ",".join(f"{n}:{e:.2e}" for n, e in rel.items())
          + f" max_layer_rel_err={rel[worst]:.3e} ({worst}) "
          f"max_logp_abs_diff={logp_diff:.3e} "
          f"max_prob_abs_diff={prob_diff:.3e}", flush=True)
    check(rel[worst] <= LAYER_RTOL, f"plan {label}: {worst} differs from "
          f"the torch plan by {rel[worst]:.3e} of its largest magnitude")
    check(logp_diff <= LOGP_ATOL, f"plan {label}: log-probabilities "
          f"differ from the torch plan's by {logp_diff:.3e}")
    check(prob_ok, f"plan {label} disagrees with the torch plan "
          f"(max abs diff {prob_diff:.3e})")


def images_per_s(torch, run, images) -> float:
    """N_BATCHES batches through ``run``, host clock around a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in images:
        run(x)
    torch.cuda.synchronize()
    return N_BATCHES * BATCH / (time.perf_counter() - t0)


def phase_measured(torch, kern, net, params, images, plans, acts_torch,
                   probs_torch):
    """4b. The paper's profile-then-offload at BATCH in fp32: time every
    AlexNet layer on both engines into a cache under build/, re-price the
    default plan from it (compile_plan(price="measured")), run that plan
    and hold it to the PyTorch plan; then its images/s beside the three
    plans of phase 4, in turns on this host."""
    from repro_torch.core import engines as eng
    from repro_torch.core import scheduler
    from repro_torch.core.plan import compile_plan
    from repro_torch.profiling import (MeasuredPricer, ProfileCache,
                                       calibration_report, profile_network)

    engines = eng.DEFAULT_ENGINES
    cache = ProfileCache(str(ROOT / "build" / "profile_cache_chip_smoke.json"))
    for fn in kern.values():           # every count to 0 before the path
        fn.launches = 0
    t0 = time.perf_counter()
    measurements = profile_network(net, engines, batch=BATCH,
                                   warmup=PROFILE_WARMUP,
                                   repeats=PROFILE_REPEATS, cache=cache)
    cache.save()
    check(len(measurements) == len(net) * len(engines),
          f"profiled {len(measurements)} of {len(net) * len(engines)} pairs")
    pricer = MeasuredPricer(cache, measure_on_miss=False, autosave=False)
    plan = scheduler.schedule(net, engines, batch=BATCH, price="measured",
                              pricer=pricer)
    with torch.inference_mode():
        run = compile_plan(plans["default"].plan, price="measured",
                           pricer=pricer, batch=BATCH)
        check(run.plan == plan, "compile_plan(price='measured') built "
              "another plan than schedule(price='measured')")
        run(images[0], params)          # first-call costs stay out
        torch.cuda.synchronize()
        before = {name: fn.launches for name, fn in kern.items()}
        rate = images_per_s(torch, lambda x: run(x, params), images)
        totals = {name: fn.launches for name, fn in kern.items()}
    print(f"[measured] profiled {len(measurements)} (layer, engine) pairs "
          f"at batch {BATCH} (warmup {PROFILE_WARMUP}, median of "
          f"{PROFILE_REPEATS}) and ran the plan in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the scheduler's gate: each layer on the engine of the smaller median
    medians = {(m.layer, m.engine): m.t_median for m in measurements}
    for a in plan.assignments:
        t = {e.name: medians[(a.spec.name, e.name)] for e in engines}
        fastest = min(t, key=t.get)      # a tie keeps the first, torch
        print(f"[measured] {a.spec.name}: " + ", ".join(
            f"{name} {ms * 1e3:.4f} ms" for name, ms in t.items())
            + f" -> {a.engine}", flush=True)
        check(a.engine == fastest and a.cost.t_total == t[fastest],
              f"{a.spec.name} on {a.engine}, but {fastest} measured "
              f"faster ({t})")
    delta = {name: totals[name] - before[name] for name in kern}
    want = {name: 0 for name in kern}
    for a in plan.assignments:
        if a.engine == "hopper":
            want[KERNEL_OF[a.spec.kind]] += N_BATCHES
    print(f"[measured] plan: " + ", ".join(
        f"{a.spec.name}={a.engine}" for a in plan.assignments)
        + f" images/s={rate:.1f} launches={delta} "
        f"(profile and plan: {totals})", flush=True)
    check(delta == want, f"measured plan: launches {delta}, expected {want}")
    check(all(totals[n] for n in CNN_KERNELS),
          f"a kernel never ran on the measured path: {totals}")

    with torch.inference_mode():
        acts = run.activations(images[0], params)
        probs = [run(x, params) for x in images]
        gate_plan(torch, net, "measured", acts, probs, acts_torch,
                  probs_torch, "measured")
        # images/s of the four plans, in turns, median of three rounds
        runs = {"measured": lambda x: run(x, params),
                **{label: model for label, model in plans.items()}}
        rates = {label: [] for label in runs}
        for r in range(3):
            order = list(runs)[r:] + list(runs)[:r]
            for label in order:
                rates[label].append(images_per_s(torch, runs[label], images))
    print("[measured] images/s in turns (median of 3): " + ", ".join(
        f"{label}={statistics.median(v):.1f}" for label, v in rates.items()),
        flush=True)

    for e in engines:
        rep = calibration_report(e, list(net), measurements, batch=BATCH)
        print(f"[measured] calibration {e.name}: MAPE analytic "
              f"{rep.analytic_mape:.2%} calibrated {rep.calibrated_mape:.2%}"
              f" ({len(rep.predictions)} layers)", flush=True)

    # the paper's Figs. 7-8 part 2 (cuBLAS against the matmul kernel) and
    # Table III's shared memory per block of every kernel
    from benchmarks import bench_torch_paper as paper
    rows = paper.fig7_fig8_measured_rows() + paper.smem_rows()
    for bench, name, value, derived, status in rows:
        print(f"[paper] {bench},{name},{value},{derived!r},{status}",
              flush=True)
    check(all(r[4] not in ("MISMATCH", "OVERFLOW") for r in rows),
          "paper bench rows failed")
    smem_kernels = {r[1].split("_")[0] for r in rows if r[0] == "table3_smem"}
    check(smem_kernels == {"conv2d", "pool", "lrn", "matmul", "flash",
                           "paged"}, f"smem rows for {smem_kernels}")
    return totals


def attended_pairs(s, t, window=None, q_offset=None) -> int:
    """(query, key) pairs a causal query set attends, query i at key
    position i + q_offset (default t - s: query ends aligned with key ends),
    at most `window` keys."""
    qpos = np.arange(s) + (t - s if q_offset is None else q_offset)
    lo = np.zeros(s) if window is None else np.maximum(0, qpos - window + 1)
    return int(np.maximum(0, np.minimum(t - 1, qpos) - lo + 1).sum())


def paged_tables(rng, pos_list, nb):
    """Block tables for slots at pos_list: shuffled physical pages of an
    arena of len(pos_list) * nb pages plus a trash page; the last slot is an
    inactive one whose every entry is page 0."""
    b = len(pos_list)
    ids = rng.permutation(b * nb)
    bt = ids.reshape(b, nb).astype(np.int32)
    bt[-1] = 0
    return bt, np.asarray(pos_list, np.int32)


def sensitize(torch, q, k) -> None:
    """Make an unmasked (B, HQ, S, D) x (B, HK, T, D) bf16 case hold every
    key tile to account, in place: q x 4 (logits ~N(0, 16), so each row's
    mass sits on a few keys and every 64-key tile holds some rows' top
    keys); each of the last 4 keys aligned with one row per kv head
    (query 2 + j of the group's head j % G) at a logit of ~30, so the
    ragged tail carries nearly all of those rows' mass; the keys' first
    coordinate set to 3 and query 0's to -100 in every head, so that row's
    every key sits ~300/sqrt(D) below a zero logit (softmax does not move,
    a key of zeros past T would take the row's mass)."""
    b, hq, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = hq // hk
    q.mul_(4)
    for j in range(min(4, t)):
        heads = torch.arange(hk, device=q.device) * g + j % g
        rows = q[:, heads, min(2 + j, s - 1)].float()          # (B, HK, D)
        k[:, :, t - 4 + j] = (rows * (30 * d ** 0.5) / rows.pow(2).sum(
            -1, keepdim=True)).to(k.dtype)
    k[..., 0] = 3
    q[:, :, 0, 0] = -100


def plant_edges(torch, q, k, edges) -> None:
    """Make a causal (B, HQ, S, D) x (B, HK, T, D) bf16 case hold its mask's
    edges to account, in place: q x 4 (as in `sensitize`), and for the j-th
    (row, inside, outside) of ``edges`` the keys at ``inside`` (the last one
    the row attends at that edge of its mask) and ``outside`` (the first
    one it must not) aligned with that row of query head j % HQ at a logit
    of ~30.  The right mask gives the row the value at ``inside``; a mask
    one key off at that edge halves that value's weight or drops it."""
    d, g = q.shape[-1], q.shape[1] // k.shape[1]
    q.mul_(4)
    for j, (row, inside, outside) in enumerate(edges):
        head = j % q.shape[1]
        r = q[:, head, row].float()                             # (B, D)
        k[:, head // g, [inside, outside]] = (r * (30 * d ** 0.5) / r.pow(
            2).sum(-1, keepdim=True)).to(k.dtype)[:, None]


def masked_plain(torch, q, k, v, keep):
    """The plain attention of kernels/ref.py's attention_ref under an
    explicit (S, T) mask ``keep``: a faulty kernel's output."""
    hq, hk = q.shape[1], k.shape[1]
    k, v = (x.float().repeat_interleave(hq // hk, dim=1) for x in (k, v))
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * (
        1.0 / q.shape[-1] ** 0.5)
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")),
                          dim=-1).nan_to_num(0.0)
    return torch.einsum("bhst,bhtd->bhsd", probs, v).to(q.dtype)


def lm_kernel_cases(torch, F, ref, kern, rng):
    """(kernel, label, dtype, main_path, flops, bytes, kernel_fn, plain_fn,
    library_fn, faults) for the attention kernels at qwen2-1.5B's head
    shapes in bf16, and flash's edge cases; main_path marks the shapes the
    prefill and serve phases give them; the "phi-" cases are phase 11's
    (phi3.5-MoE's heads).  ``faults`` is None, or for the sensitized cases
    (unmasked, or causal with planted edges) the plain version run as a
    faulty kernel would ({name: fn}): their
    error must pass SENSITIZED_REL where the kernel's must not.  Operations
    and bytes count what these inputs need: the keys each query attends
    (causal, and for paged only positions <= pos), each input read once
    and the output written once."""
    hq, hk, d = 12, 2, 128

    def t(*shape, dtype="bfloat16"):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(getattr(torch, dtype))

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    cases = []

    def paged_case(label, pos_list, max_seq, main, heads=(hq, hk)):
        hq, hk = heads
        b, nb = len(pos_list), -(-max_seq // PAGE)
        tb = b * nb + 1                                 # + the trash page
        q, ka, va = t(b, hq, 1, d), t(tb, hk, PAGE, d), t(tb, hk, PAGE, d)
        bt, pos = paged_tables(rng, pos_list, nb)
        bt_d, pos_d = torch.from_numpy(bt).cuda(), torch.from_numpy(pos).cuda()
        live = pos >= 0
        keys = int((pos + 1)[live].sum())
        pages = int((pos // PAGE + 1)[live].sum())
        # a slot with nothing to attend (pos < 0) is written as zeros, as
        # the Pallas kernel writes it; the plain version averages its rows
        live_d = torch.from_numpy(live).cuda()[:, None, None, None]

        def plain():
            return torch.where(live_d, ref.paged_attention_ref(
                q, ka, va, bt_d, pos_d, max_seq=max_seq), 0).to(q.dtype)
        n_bytes = (nbytes(q) * 2 + 2 * pages * hk * PAGE * d * 2
                   + 4 * (pages + b))
        flat = bt_d.flatten()
        kpos = torch.arange(nb * PAGE, device="cuda")
        mask = (kpos[None, :] <= pos_d[:, None])[:, None, None, :]

        def library():                  # gather pages, then SDPA
            def rows(a):
                g = a.index_select(0, flat).view(b, nb, hk, PAGE, d)
                g = g.permute(0, 2, 1, 3, 4).reshape(b, hk, nb * PAGE, d)
                return g.repeat_interleave(hq // hk, dim=1)
            return F.scaled_dot_product_attention(q, rows(ka), rows(va),
                                                  attn_mask=mask)

        cases.append((
            "paged_attention", label, "bfloat16", main, 4 * hq * d * keys,
            n_bytes,
            lambda: kern["paged_attention"](q, ka, va, bt_d, pos_d), plain,
            library, None))

    def flash_case(label, b, s, main, tk=None, hd=d, window=None,
                   dtype="bfloat16", q_offset=None, heads=(hq, hk),
                   causal=True, edges=None):
        hq, hk = heads
        tk = s if tk is None else tk
        q = t(b, hq, s, hd, dtype=dtype)
        k, v = t(b, hk, tk, hd, dtype=dtype), t(b, hk, tk, hd, dtype=dtype)
        faults = None
        if edges is not None:           # a causal case held at its edges
            plant_edges(torch, q, k, edges)
            qpos = torch.arange(s, device="cuda")[:, None] + (
                tk - s if q_offset is None else q_offset)
            kpos = torch.arange(tk, device="cuda")[None, :]

            def keep(late=0, win=window):
                m = kpos <= qpos + late
                return m if win is None else m & (kpos > qpos - win)

            def faulty(m):
                return lambda: masked_plain(torch, q, k, v, m)
            faults = {"causal edge one key later": faulty(keep(late=1)),
                      "causal edge one key earlier": faulty(keep(late=-1)),
                      "without key tile 1": faulty(
                          keep() & ((kpos < 64) | (kpos >= 128)))}
            if window is not None:
                for w, what in ((-64, "one tile narrower"),
                                (-1, "one key narrower"),
                                (1, "one key wider"),
                                (64, "one tile wider")):
                    faults[f"window {what}"] = faulty(keep(win=window + w))
            if tk % 64:
                faults["without the ragged last key tile"] = faulty(
                    keep() & (kpos < tk - tk % 64))
        if not causal:                  # every key: the cross-attention
            sensitize(torch, q, k)
            q_offset, pairs = 0, s * tk

            def library():
                return F.scaled_dot_product_attention(q, kr, vr)

            def over(lo, hi, pad=0):
                zeros = k.new_zeros((b, hk, pad, hd))
                return lambda: ref.attention_ref(
                    q, torch.cat([k[:, :, lo:hi], zeros], 2),
                    torch.cat([v[:, :, lo:hi], zeros], 2), causal=False)
            faults = {"without the last 4 keys": over(0, tk - 4),
                      "without the first key tile": over(64, tk)}
            if tk % 64:
                faults["over zero keys past T"] = over(0, tk, -tk % 64)
        # SDPA's is_causal places query i at key position i
        elif window is None and (tk == s or q_offset == 0):
            def library():
                return F.scaled_dot_product_attention(q, kr, vr,
                                                      is_causal=True)
        else:
            qpos = torch.arange(s, device="cuda")[:, None] + (
                tk - s if q_offset is None else q_offset)
            kpos = torch.arange(tk, device="cuda")[None, :]
            mask = kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window

            def library():
                return F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=mask)
        # the library's KV heads repeated (after sensitize, which moves k)
        kr, vr = (x.repeat_interleave(hq // hk, dim=1) for x in (k, v))
        if causal:
            pairs = attended_pairs(s, tk, window, q_offset)
        cases.append((
            "flash_attention", label, dtype, main, 4 * b * hq * hd * pairs,
            2 * nbytes(q) + nbytes(k, v),
            lambda: kern["flash_attention"](q, k, v, causal=causal,
                                            window=window, q_offset=q_offset),
            lambda: ref.attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset),
            library, faults))

    # the serve phase's decode shape: 8 slots over 160 positions, one on a
    # page's last position, one on the next page's first, one inactive
    serve_seq = PROMPT + GEN
    paged_case("serve-8x160", [0, 15, 16, 47, 90, 128, 159, 0], serve_seq,
               True)
    paged_case("8x2048", [0, 15, 16, 300, 1023, 1500, 2047, 0], 2048, False)
    # positions on the kernel's split boundaries (PAGES_PER_SPLIT pages of
    # PAGE: every 64 positions), and a slot with nothing to attend
    paged_case("splits-8x320", [63, 64, 65, 127, 128, 255, -1, 0], 320, False)
    flash_case("prefill-1x512", 1, PREFILL_TOKENS, True)
    for b, s in ((4, 512), (1, 2048), (4, 2048)):
        flash_case(f"{b}x{s}", b, s, False)
    # edge cases of the tensor-core body, and the fp32 (CUDA-core) body
    flash_case("ragged-300", 1, 300, False)
    flash_case("s37-t100", 1, 37, False, tk=100, q_offset=100 - 37)
    flash_case("s37-t100-q0", 1, 37, False, tk=100, q_offset=0)
    flash_case("window64-1x512", 1, 512, False, window=64)
    flash_case("d64-1x512", 1, 512, False, hd=64)
    flash_case("fp32-1x100-d64", 1, 100, False, hd=64, dtype="float32")
    # phase 11's shapes: phi3.5-MoE's 32 query heads over 8 kv heads
    paged_case("phi-8x160", [0, 15, 16, 47, 90, 128, 159, 0], serve_seq,
               False, heads=PHI_HEADS)
    flash_case("phi-1x512", 1, PREFILL_TOKENS, False, heads=PHI_HEADS)
    # phase 13's unmasked calls (causal=False): seamless's encoder and
    # cross-attention (16 over 16 heads, D 64), llama-vision's
    # cross-attention of a 512-token prompt over 6404 image positions (64
    # over 8, D 128: a ragged last key tile), and S 37 against T 100
    flash_case("xattn-seamless-1x512", 1, CROSS_FRAMES, False, hd=64,
               heads=(16, 16), causal=False)
    flash_case("xattn-vision-512x6404", 1, PREFILL_TOKENS, False, tk=6404,
               heads=(64, 8), causal=False)
    flash_case("xattn-s37-t100", 1, 37, False, tk=100, causal=False)
    # the head dims every SMOKE config (16) and recurrentgemma-2b (256)
    # give the kernel: D 16 causal and ragged and unmasked with S != T (6
    # over 2 heads), D 256 at recurrentgemma's attention (10 over 1 head,
    # a window of 2048 that bites at 4096), and the fp32 body at each
    # the causal ones with rows planted at their mask's edges: on the
    # diagonal (key i inside, i + 1 outside) at tile ends and in the ragged
    # tile, and for D 256 at the window's far edge (key i - 2047 inside,
    # i - 2048 outside), at a tile boundary (keys 64 and 63) among them
    flash_case("d16-ragged-300", 1, 300, False, hd=16, heads=(6, 2),
               edges=[(i, i, i + 1) for i in (63, 255, 298)])
    flash_case("xattn-d16-s37-t100", 1, 37, False, tk=100, hd=16,
               heads=(6, 2), causal=False)
    flash_case("rg-d256-w2048-4096", 1, 4096, False, hd=256,
               heads=RG_HEADS, window=RG_WINDOW,
               edges=[(i, i - RG_WINDOW + 1, i - RG_WINDOW)
                      for i in (2111, 3000, 4095)]
               + [(i, i, i + 1) for i in (127, 1000, 2500)])
    flash_case("fp32-d16-1x300", 1, 300, False, hd=16, heads=(6, 2),
               dtype="float32")
    flash_case("fp32-d256-w64-1x300", 1, 300, False, hd=256, heads=RG_HEADS,
               window=64, dtype="float32")
    return cases


def paged_invariance(torch, kern, rng) -> None:
    """The serve shape's slot at position 90, run alone, inside the 8-slot
    serve batch (10 pages a slot) and inside the 8 x 2048 batch (128 pages
    a slot): its output rows must be the same bits every time."""
    hq, hk, d = 12, 2, 128
    nb_serve, nb_wide = -(-(PROMPT + GEN) // PAGE), 2048 // PAGE
    serve_pos = [0, 15, 16, 47, 90, 128, 159, 0]
    wide_pos = [0, 15, 16, 300, 90, 1500, 2047, 0]
    slot = serve_pos.index(90)
    tb = len(serve_pos) * nb_wide + 1

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(torch.bfloat16)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    q, ka, va = t(len(serve_pos), hq, 1, d), t(tb, hk, PAGE, d), \
        t(tb, hk, PAGE, d)
    bt, _ = paged_tables(rng, wide_pos, nb_wide)
    runs = {
        "alone": kern(q[slot:slot + 1].contiguous(), ka, va,
                      dev(bt[slot:slot + 1, :nb_serve]), dev([90])),
        "serve-8x160": kern(q, ka, va, dev(bt[:, :nb_serve]),
                            dev(serve_pos))[slot:slot + 1],
        "8x2048": kern(q, ka, va, dev(bt), dev(wide_pos))[slot:slot + 1],
    }
    torch.cuda.synchronize()
    same = {label: torch.equal(out, runs["alone"])
            for label, out in runs.items()}
    print(f"[lm-kernels] paged_attention slot at pos 90 alone, in the "
          f"serve batch and in the 8x2048 batch: bitwise_equal={same}",
          flush=True)
    check(all(same.values()), f"paged attention: a slot's output changes "
          f"with its batch {same}")


def phase_lm_kernels(torch, F, ref, kern):
    """Each attention kernel against its plain version; returns the main
    path's per-call numbers by kernel, max_abs_err over every shape."""
    rng = np.random.default_rng(1)
    main_case, worst, failed, profiled = {}, {}, [], []
    for (name, label, dtype, main, flops, n_bytes, fn, plain,
         library, faults) in lm_kernel_cases(torch, F, ref, kern, rng):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all())
        if faults is None:
            ok = ok and torch.allclose(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        else:
            scale = want.float().abs().max().item()
            ok = ok and err <= SENSITIZED_REL * scale
            readings = {f: (g().float() - want.float()).abs().max().item()
                        / scale for f, g in faults.items()}
            print(f"[lm-kernels] {name} {label}: max_abs_err {err:.3e} = "
                  f"{err / scale:.4e} of max|plain| {scale:.4f} (limit "
                  f"{SENSITIZED_REL}); the plain version " + ", ".join(
                      f"{f}: {r:.4f}" for f, r in readings.items()),
                  flush=True)
            if min(readings.values()) <= SENSITIZED_REL:
                failed.append(f"{name} {label}: a fault's reading "
                              f"{readings} within the limit: the inputs do "
                              f"not hold the kernel's keys and mask to "
                              f"account")
        ms, plain_ms, lib_ms = (time_ms(torch, f)
                                for f in (fn, plain, library))
        dev_ms, lib_dev_ms = (time_ms(torch, f, queued=True)
                              for f in (fn, library))
        bound_ms, bound_by = bound(flops, n_bytes, dtype)
        print(f"[lm-kernels] {name:<15} {label:<14} {dtype:<8} "
              f"out={tuple(got.shape)} max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
              f" device_ms={dev_ms:.4f} library_device_ms={lib_dev_ms:.4f}",
              flush=True)
        if not ok:
            failed.append(f"{name} {label}: max_abs_err {err:.3e}")
        if min(ms, plain_ms, lib_ms, dev_ms, lib_dev_ms) < bound_ms:
            failed.append(f"{name} {label}: a time below the bound "
                          f"{bound_ms:.4f} ms: the bound counts too much")
        worst[name] = max(worst.get(name, 0.0), err)
        if label in ("prefill-1x512", "4x2048", "serve-8x160", "8x2048"):
            profiled.append((label, fn, library))
        if main:
            main_case[name] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound_ms,
                               "device_ms": dev_ms,
                               "library_device_ms": lib_dev_ms,
                               "bound_by": bound_by}
    check(not failed, "attention kernel checks failed: " + "; ".join(failed))
    paged_invariance(torch, kern["paged_attention"], rng)
    for label, fn, library in profiled:
        print(f"[lm-kernels] profile {label}: kernel "
              f"{kernel_times(torch, fn)} | library "
              f"{kernel_times(torch, library)}", flush=True)
    for name, case in main_case.items():
        case["max_abs_err"] = worst[name]
    return main_case


def device_profile(torch, fn, label: str) -> None:
    """Where the time goes in one call of ``fn``: torch.profiler's device
    kernel times summed by kind, against the host-clock wall time of the
    same call (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = (("paged_attention", ("paged_attention_split_kernel",
                                  "paged_attention_combine_kernel")),
             ("flash_attention", ("flash_wgmma_kernel", "flash_ffma_kernel")),
             ("gemm", ("gemm", "Gemm", "xmma", "cutlass", "nvjet", "gemv")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, n_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, keys in kinds
                     if any(key in ev.key for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total
        n_kernels += ev.count
    device_ms = sum(by_kind.values()) / 1e3
    if device_ms == 0:
        print(f"[{label}] profile: wall_ms={wall_ms:.3f}; the profiler saw "
              "no device time (device busy share not measured)", flush=True)
        return
    print(f"[{label}] profile: wall_ms={wall_ms:.3f} device_ms="
          f"{device_ms:.3f} device_busy={device_ms / wall_ms:.4f} "
          f"kernels={n_kernels} by_kind_ms=" + ",".join(
              f"{k}:{v / 1e3:.3f}" for k, v in sorted(
                  by_kind.items(), key=lambda kv: -kv[1])), flush=True)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


class ShadowAttention:
    """Inside the block, each kernel call of the model's attention (the
    flash kernel in ``forward``, the paged kernel in a decode step) is also
    computed by the plain impl ("chunked", "ref") on the same inputs, and
    the error relative to the plain output's largest magnitude is kept in
    ``rels``; the model goes on with the kernel's output.  This holds each
    kernel call at the model's own inputs where a routed model's logits
    cannot be compared: an MoE router with random weights turns bf16
    rounding into other experts."""

    def __init__(self, torch):
        from repro_torch.models import attention as attn_lib
        self.lib, self.rels = attn_lib, []

    def __enter__(self):
        lib = self.lib
        self.attend, self.paged = lib.attend, lib.paged_decode_attention

        def attend(q, k, v, *, impl="dot", **kw):
            out = self.attend(q, k, v, impl=impl, **kw)
            if impl == "hopper":
                self.rels.append(_rel(out, self.attend(q, k, v,
                                                       impl="chunked", **kw)))
            return out

        def paged(*args, impl="ref", **kw):
            out = self.paged(*args, impl=impl, **kw)
            if impl == "hopper":
                self.rels.append(_rel(out, self.paged(*args, impl="ref",
                                                      **kw)))
            return out

        lib.attend, lib.paged_decode_attention = attend, paged
        return self

    def __exit__(self, *exc):
        self.lib.attend = self.attend
        self.lib.paged_decode_attention = self.paged


def phase_prefill(torch, kern, cfg, params, tag="prefill"):
    """forward() of the full-width model on one prompt, flash kernel on."""
    import dataclasses
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(
        1, PREFILL_TOKENS), dtype=np.int64)).cuda()
    hopper = dataclasses.replace(cfg, attention_impl="hopper")
    plain = dataclasses.replace(cfg, attention_impl="chunked")
    with torch.no_grad():
        T.forward(params, hopper, tokens)              # first-call costs
        torch.cuda.synchronize()
        for fn in kern.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits, cache = T.forward(params, hopper, tokens, emit_cache=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {name: fn.launches for name, fn in kern.items()}
        t0 = time.perf_counter()
        want, _ = T.forward(params, plain, tokens)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # yardstick for the limit: the two plain impls against each other
        dot, _ = T.forward(params, dataclasses.replace(
            cfg, attention_impl="dot"), tokens)
        device_profile(torch, lambda: T.forward(params, hopper, tokens),
                       tag)
        with ShadowAttention(torch) as shadow:
            T.forward(params, hopper, tokens)
    plain_rel = _rel(dot, want)
    rel = _rel(logits, want)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    routed = cfg.n_experts > 0
    print(f"[{tag}] {cfg.name} 1x{PREFILL_TOKENS} hopper ms={ms:.3f} "
          f"chunked_ms={plain_ms:.3f} logits={tuple(logits.shape)} "
          f"max_rel_err={rel:.3e} (dot vs chunked: {plain_rel:.3e}"
          + ("; not gated: the MoE routes the two plain impls' rounding "
             "to other experts" if routed else "")
          + f") argmax_agreement={agree:.4f} each layer's flash call "
          f"against chunked on its inputs: max_rel_err="
          f"{max(shadow.rels):.3e} over {len(shadow.rels)} calls "
          f"launches={launches}", flush=True)
    check(logits.shape == (1, PREFILL_TOKENS, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite")
    check(len(cache["layers"]) == cfg.n_layers, "prefill cache layers")
    n_attn = cfg.layer_types().count("attn")
    check(launches["flash_attention"] == n_attn > 0
          and sum(launches.values()) == n_attn,
          f"prefill launches {launches}, expected flash_attention x "
          f"{n_attn} (one per attention layer) and nothing else")
    check(routed or rel <= PREFILL_RTOL, f"prefill logits differ from "
          f"the chunked impl by {rel:.3e} of their largest magnitude")
    check(len(shadow.rels) == cfg.layer_types().count("attn")
          and max(shadow.rels) <= PREFILL_RTOL, f"a flash call differs from "
          f"chunked on its inputs by {max(shadow.rels):.3e}")
    return launches


def phase_serve(torch, kern, cfg, params, tag="serve", speculate=True):
    """EngineLoop.run on the paged kernel, one decode step held against
    the ref impl, and the same requests served on the ref impl, on the
    paged and the dense layout (and, with ``speculate``, with forced
    speculation: identity_gates)."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineLoop, SlotEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.request import Request, synthetic_workload

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    max_seq = PROMPT + GEN

    def workload():
        return synthetic_workload(SLOTS, rate=1e9, vocab=cfg.vocab,
                                  prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                  seed=3)

    def loop_for(c, loop_cls=EngineLoop, n_slots=SLOTS, **kw):
        """A loop with its step captured (warmup), ready to run."""
        loop = loop_cls(c, params, n_slots=n_slots, max_seq=max_seq,
                        block_size=PAGE, **kw)
        loop.warmup()
        torch.cuda.synchronize()
        return loop

    def serve(loop, reqs):
        metrics = loop.run(reqs)
        torch.cuda.synchronize()
        return metrics.summary()

    # first-call costs: a short request through each impl
    for c in (hopper, ref_cfg):
        serve(loop_for(c), synthetic_workload(
            1, rate=1e9, vocab=cfg.vocab, prompt_lens=(4,), gen_lens=(2,),
            seed=9))
    loop = loop_for(hopper)
    for fn in kern.values():
        fn.launches = 0
    reqs = workload()
    summary = serve(loop, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    steps = summary["steps"]
    print(f"[{tag}] {cfg.name} hopper requests_done="
          f"{summary['requests_done']} steps={steps} tok/s="
          f"{summary['tok_per_s']:.1f} ttft_p50_s={summary['ttft_p50_s']:.4f}"
          f" tpot_p50_s={summary['tpot_p50_s']:.5f} elapsed_s="
          f"{summary['elapsed_s']:.3f} launches={launches}", flush=True)
    check(summary["requests_done"] == SLOTS, f"served "
          f"{summary['requests_done']} of {SLOTS} requests")
    check(all(len(r.output) == GEN for r in reqs), "short outputs")
    check(launches["paged_attention"] == steps * cfg.n_layers
          and sum(launches.values()) == launches["paged_attention"],
          f"serve launches {launches}, expected paged_attention x "
          f"{steps} steps x {cfg.n_layers} layers and nothing else")

    ref_reqs = workload()
    ref_summary = serve(loop_for(ref_cfg), ref_reqs)
    agree = np.mean([np.mean(np.asarray(a.output) == np.asarray(b.output))
                     for a, b in zip(reqs, ref_reqs)])
    print(f"[{tag}] {cfg.name} ref tok/s={ref_summary['tok_per_s']:.1f} "
          f"ttft_p50_s={ref_summary['ttft_p50_s']:.4f} elapsed_s="
          f"{ref_summary['elapsed_s']:.3f}; greedy tokens equal to the "
          f"hopper run: {agree:.4f} (reported, not gated)", flush=True)
    identity_gates(torch, cfg, params, ref_reqs, workload, loop_for, serve,
                   tag, speculate)

    # one decode step, kernel against plain, from a live mid-decode state
    pool = KVPool(SLOTS, max_seq, block_size=PAGE)
    eng = SlotEngine(hopper, params, pool, kv_layout="paged")
    for r in workload()[:SLOTS - 1]:       # the last slot stays inactive
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    mid = PROMPT + GEN // 4                # a quarter into decoding
    eng.dispatch(mid, eng.active)
    tokens = torch.randint(0, cfg.vocab, (SLOTS, 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    active = torch.tensor(eng.active, device="cuda")
    outs, shadow = [], ShadowAttention(torch)
    with torch.no_grad():
        for c in (hopper, ref_cfg):
            cache = {"layers": [{k: a.clone() for k, a in layer.items()}
                                for layer in eng.cache["layers"]],
                     "pos": eng.cache["pos"].clone(),
                     "block_tables": eng.cache["block_tables"].clone()}
            with shadow:                 # records the hopper step's calls
                outs.append(T.decode_step_slots_paged(
                    eng.params, c, cache, tokens, active,
                    max_seq=max_seq)[0])
        left = int((eng.steps_total - eng.steps_done)[eng.active].min())
        device_profile(torch, lambda: eng.dispatch(min(8, left), eng.active),
                       tag)
    live = active.nonzero().flatten()
    rel = _rel(outs[0][live], outs[1][live])
    routed = cfg.n_experts > 0
    print(f"[{tag}] one decode step at pos {mid}: hopper vs ref "
          f"max_rel_err={rel:.3e}"
          + (" (not gated: the MoE routes rounding to other experts)"
             if routed else "")
          + f"; each layer's paged call against ref on its inputs: "
          f"max_rel_err={max(shadow.rels):.3e} over {len(shadow.rels)} "
          "calls", flush=True)
    check(routed or rel <= DECODE_RTOL, f"decode-step logits differ from "
          f"the ref impl by {rel:.3e} of their largest magnitude")
    check(len(shadow.rels) == cfg.n_layers
          and max(shadow.rels) <= DECODE_RTOL, f"a paged call differs from "
          f"ref on its inputs by {max(shadow.rels):.3e}")
    return launches, summary, ref_summary


def _token_agreement(a, b) -> float:
    """Share of positions where two runs' greedy tokens are equal."""
    return float(np.mean([np.mean(np.asarray(x.output) == np.asarray(y.output))
                          for x, y in zip(a, b)]))


def identity_gates(torch, cfg, params, ref_reqs, workload, loop_for, serve,
                   tag, speculate):
    """The JAX package's serving identities under its own impl ("ref"), on
    the card: the dense layout's tokens equal the paged layout's bit for
    bit (gated), and forced speculation (self-draft, at each SPEC_RUNS
    slot count and depth) against plain decode (see spec_vs_plain)."""
    import dataclasses
    from repro_torch.serving import SpecPlan, SpeculativeEngineLoop
    from repro_torch.serving.request import synthetic_workload

    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    dense_reqs = workload()
    serve(loop_for(ref_cfg, kv_layout="dense"), dense_reqs)
    same = [r.output for r in ref_reqs] == [r.output for r in dense_reqs]
    agree = _token_agreement(ref_reqs, dense_reqs)
    print(f"[{tag}] {cfg.name} ref: dense-layout tokens bitwise equal to the "
          f"paged layout's: {same} ({agree:.4f} of tokens)", flush=True)
    check(same, "under the ref impl the dense layout's greedy tokens differ "
          "from the paged layout's")
    if not speculate:
        return

    def mixed(n):
        """The serve CLI's workload (phase 8's) over ``n`` requests:
        speculation engages only once bursts stop at staggered
        completions."""
        return synthetic_workload(n, rate=1e9, vocab=cfg.vocab,
                                  prompt_lens=(PROMPT // 2, PROMPT),
                                  gen_lens=(GEN // 8, GEN // 2, GEN), seed=1)

    for slots, k, gated in SPEC_RUNS:
        n = max(SERVE_ENTRY["requests"], slots)
        plain_reqs, spec_reqs = mixed(n), mixed(n)
        serve(loop_for(ref_cfg, n_slots=slots), plain_reqs)
        loop = loop_for(ref_cfg, n_slots=slots,
                        plan=SpecPlan(ref_cfg, params, k=k, forced=True),
                        loop_cls=SpeculativeEngineLoop)
        summary = serve(loop, spec_reqs)
        spec_vs_plain(torch, cfg, params, plain_reqs, spec_reqs, loop,
                      summary, slots, k, gated)


def spec_vs_plain(torch, cfg, params, plain_reqs, spec_reqs, loop,
                  summary, slots: int, k: int, gated: bool) -> None:
    """Forced speculation under ref against plain decode under ref: with
    ``gated`` the tokens must be equal bit for bit (the JAX package's
    identity; the verify is k+1 plain steps, so no product holds more than
    the plain step's ``slots`` rows).  Reported: for each of a layer's
    products and the head (qwen2's shapes, bf16, random rows), the smallest
    row count m whose first row differs from the 1-row product, and whether
    the first ``slots`` rows of a slots x (k+1)-row product equal the
    slots-row product's (what a verify batching its window would meet).
    Where the tokens differ: spec_divergence at full depth and, when gated,
    cut to 2 layers by window size before the check fails."""
    same = ([r.output for r in plain_reqs]
            == [r.output for r in spec_reqs])
    spec = loop.spec
    rows_v = slots * (k + 1)
    print(f"[serve] {cfg.name} ref: forced speculation (self-draft, "
          f"{slots} slots, k {k}: the verify feeds {rows_v} rows; "
          f"{spec.n_rounds} rounds, acceptance {spec.acceptance_rate}) "
          f"tokens bitwise equal to plain decode: {same} "
          f"({_token_agreement(plain_reqs, spec_reqs):.4f} of tokens"
          f"{'' if gated else '; reported, not gated'}); "
          f"requests_done={summary['requests_done']}", flush=True)
    check(summary["requests_done"] == len(spec_reqs) and spec.n_rounds > 0,
          f"speculation under ref: {summary['requests_done']} requests "
          f"done, {spec.n_rounds} rounds")
    gen = torch.Generator("cuda").manual_seed(8)
    layer = params["layers"][0]
    products = (("x@wq", layer["attn"]["wq"]), ("x@wk", layer["attn"]["wk"]),
                ("o@wo", layer["attn"]["wo"]),
                ("x@w_gate", layer["mlp"]["w_gate"]),
                ("h@w_down", layer["mlp"]["w_down"]),
                ("x@embed.T", params["embed"].T))
    rows = []
    for name, w in products:
        w = w.to(torch.bfloat16)
        x = torch.randn((rows_v, w.shape[0]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        one = x[:1] @ w
        first = next((m for m in range(2, rows_v + 1)
                      if not torch.equal((x[:m] @ w)[:1], one)), None)
        equal = torch.equal((x @ w)[:slots], x[:slots] @ w)
        rows.append(f"{name} {tuple(w.shape)}: first m={first}, "
                    f"{rows_v} vs {slots} rows equal={equal}")
    torch.cuda.synchronize()
    print("[serve] row-count probe (row 0 of an (m, K) @ (K, N) bf16 "
          "product against the 1-row product): " + "; ".join(rows),
          flush=True)
    if same:
        return
    # the verify's step against sequential steps, layer by layer: at full
    # depth for this window, then at the model's width cut to 2 layers for
    # smaller windows (b slots x m tokens), smallest first
    found = spec_divergence(torch, cfg, params, slots, k + 1)
    print(f"[serve] verify ({slots} slots x {k + 1} tokens, ref) against "
          f"{k + 1} plain steps, "
          f"first output whose bits differ (block, layer, offset, the "
          f"verify's output shape): {found}", flush=True)
    if not gated:
        return
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=2)
    cut_params = dict(params, layers=params["layers"][:2])
    shapes = {}
    for b, m in ((1, 2), (2, 2), (1, 3), (4, 2), (8, 2), (8, 3)):
        shapes[f"{b}x{m}"] = spec_divergence(torch, cut, cut_params, b, m)
    print(f"[serve] the same at 2 layers by window (slots x tokens): "
          f"{shapes}", flush=True)
    check(False, f"under the ref impl forced speculation's tokens differ "
          f"from plain decode's at {slots} slots x k {k} (first differing "
          f"output: {found})")


# the attention block a plain step calls once per layer (the verify once per
# layer and window offset), whose outputs spec_divergence compares (each
# looked up at call time)
TRACED_OPS = (("T", "_paged_attn_block"),)


def _op_outputs(torch, fn):
    """Run ``fn`` with TRACED_OPS recording their outputs, in call order:
    [(op name, tensors)]."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer as T

    mods = {"T": T, "attn": attn_lib}
    saved, calls = {}, []
    for mod, name in TRACED_OPS:
        orig = getattr(mods[mod], name)
        saved[mod, name] = orig

        def rec(*a, _orig=orig, _name=name, **kw):
            out = _orig(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((_name, [o.detach().clone() for o in outs]))
            return out

        setattr(mods[mod], name, rec)
    try:
        with torch.no_grad():
            fn()
    finally:
        for (mod, name), orig in saved.items():
            setattr(mods[mod], name, orig)
    return calls


def spec_divergence(torch, cfg, params, b: int, m: int, seed: int = 6):
    """The verify's m-token step (ref impl) against m sequential plain steps
    from one live state of ``b`` slots a quarter into decoding, layer by
    layer: the first attention block (TRACED_OPS, offset by offset, in
    layer order) whose output differs in any bit from the plain step's, as
    ("block", layer, offset, the verify's output shape), or None."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.serving import SlotEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.request import synthetic_workload

    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    max_seq = PROMPT + GEN
    pool = KVPool(b, max_seq, block_size=PAGE)
    eng = SlotEngine(ref_cfg, params, pool, kv_layout="paged")
    for r in synthetic_workload(b, rate=1e9, vocab=cfg.vocab,
                                prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                seed=seed):
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    eng.dispatch(PROMPT + GEN // 4, eng.active)
    live = torch.tensor(eng.active, device="cuda")
    window = torch.cat([eng._last_tok[:, None], torch.randint(
        0, cfg.vocab, (b, m - 1), device="cuda", dtype=torch.int32,
        generator=torch.Generator("cuda").manual_seed(7))], dim=1)

    def cloned():
        return {"layers": [{n: a.clone() for n, a in layer.items()}
                           for layer in eng.cache["layers"]],
                "pos": eng.cache["pos"].clone(),
                "block_tables": eng.cache["block_tables"].clone()}

    multi = _op_outputs(torch, lambda: T.decode_multi_step_slots_paged(
        eng.params, ref_cfg, cloned(), window, live, max_seq=max_seq,
        advance=False))
    cache = cloned()
    steps = [_op_outputs(torch, lambda i=i: T.decode_step_slots_paged(
        eng.params, ref_cfg, cache, window[:, i:i + 1], live,
        max_seq=max_seq)) for i in range(m)]
    plain = [call for step in steps for call in step]
    for n, ((_, (x,)), (_, (y,))) in enumerate(zip(multi, plain)):
        if not torch.equal(x, y):
            i, j = divmod(n, len(steps[0]))
            return ("block", j, i, tuple(x.shape))
    return None


def serve_options(api, **fields):
    """The serve CLI's options at phase 8's settings, leaf fields by name."""
    options = api.ServeOptions()
    groups = options.flat_fields()
    for name, value in dict(SERVE_ENTRY, **fields).items():
        setattr(getattr(options, groups[name]), name, value)
    return options


def graph_step_matches_eager(torch, cfg, params) -> None:
    """One decode step from a live mid-decode state, eager and as a replay
    of the engine's graph: the same logits and the same state, bit for
    bit."""
    import dataclasses
    from repro_torch.serving import SlotEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.request import synthetic_workload

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    max_seq = PROMPT + GEN
    pool = KVPool(SLOTS, max_seq, block_size=PAGE)
    eng = SlotEngine(hopper, params, pool, kv_layout="paged")
    for r in synthetic_workload(SLOTS - 1, rate=1e9, vocab=cfg.vocab,
                                prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                seed=5):
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    eng.dispatch(PROMPT + GEN // 4, eng.active)      # replays the graph
    replayed = eng.logits                # the graph's own output buffer
    state = [eng.cache["pos"], eng._last_tok, eng._out_buf] + [
        a for layer in eng.cache["layers"] for a in layer.values()]
    saved = [t.clone() for t in state]
    with torch.no_grad():
        eng._step()                      # the same step, eagerly
    eager = eng.logits.clone()
    eager_state = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    eng._graph.replay()
    torch.cuda.synchronize()
    same_state = all(torch.equal(a, b) for a, b in zip(state, eager_state))
    live = torch.tensor(eng.active, device="cuda")
    print(f"[serve-entry] one decode step, graph replay vs eager: logits "
          f"bitwise equal={torch.equal(replayed, eager)}, state bitwise "
          f"equal={same_state}, live-slot max_abs_diff="
          f"{(replayed[live].float() - eager[live].float()).abs().max():.3e}",
          flush=True)
    check(torch.equal(replayed, eager) and same_state,
          "a replay of the captured step differs from the eager step")

    # ms per step inside a burst, replayed and eager (16 more steps of the
    # same slots, still short of max_seq): whether the replays leave the
    # card idle between steps
    def per_step_ms(step) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        for _ in range(8):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 8

    with torch.no_grad():
        graph_ms = per_step_ms(eng._graph.replay)
        eager_ms = per_step_ms(eng._step)
    print(f"[serve-entry] ms per step in a burst (CUDA events, 8 steps): "
          f"graph replay {graph_ms:.3f}, eager {eager_ms:.3f}", flush=True)


def serving_identities(torch, cfg, params) -> None:
    """The JAX package's two serving identities that phases 7-10 do not
    hold, under its own impl ("ref"), at full width and depth: phase 8's
    8 requests through the static server (batches of one prompt length,
    padded to the 8 slots' rows) against the continuous engine, per request
    bitwise; and a shared-prefix workload of 8 requests over 4 slots (later
    requests map a live donor's published prefix pages) served with and
    without prefix sharing, bitwise, with some prefix actually shared."""
    import dataclasses
    from repro_torch.serving import EngineLoop
    from repro_torch.serving.api import Server
    from repro_torch.serving.request import (prefix_shared_workload,
                                             synthetic_workload)

    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    max_seq = PROMPT + GEN

    def workload():                     # phase 8's: the serve CLI's mix
        return synthetic_workload(SERVE_ENTRY["requests"], rate=1e9,
                                  vocab=cfg.vocab,
                                  prompt_lens=(PROMPT // 2, PROMPT),
                                  gen_lens=(GEN // 8, GEN // 2, GEN), seed=1)

    def served(reqs, n_slots=SLOTS, **kw):
        loop = EngineLoop(ref_cfg, params, n_slots=n_slots, max_seq=max_seq,
                          block_size=PAGE, **kw)
        loop.warmup()
        check(loop.run(reqs).n_done == len(reqs), "identity run unfinished")
        torch.cuda.synchronize()
        return {r.rid: r.output for r in reqs}

    continuous = served(workload())
    server = Server(ref_cfg, params, max_seq)
    static, groups = {}, {}
    for r in workload():
        groups.setdefault(r.prompt_len, []).append(r)
    for grp in groups.values():
        for i in range(0, len(grp), SLOTS):
            chunk = grp[i:i + SLOTS]
            rows = [r.prompt for r in chunk]
            rows += [rows[-1]] * (SLOTS - len(rows))
            toks = server.generate(
                torch.from_numpy(np.stack(rows)).cuda(),
                max(r.max_new_tokens for r in chunk)).cpu().numpy()
            for j, r in enumerate(chunk):
                static[r.rid] = toks[j, :r.max_new_tokens].tolist()
    same = static == continuous
    agree = np.mean([np.mean(np.asarray(static[rid]) == np.asarray(toks))
                     for rid, toks in continuous.items()])
    print(f"[serve-entry] {cfg.name} ref: static server's tokens (batches "
          f"of one prompt length, {SLOTS} rows) bitwise equal to the "
          f"continuous engine's: {same} ({agree:.4f} of tokens)", flush=True)
    check(same, "under the ref impl the static server's greedy tokens "
          "differ from the continuous engine's")

    def shared_workload():
        return prefix_shared_workload(
            SERVE_ENTRY["requests"], rate=1e9, vocab=cfg.vocab,
            shared_prefix_len=PROMPT // 2, suffix_lens=(PROMPT // 4,
                                                        PROMPT // 2),
            gen_lens=(GEN // 8, GEN // 2, GEN), seed=1)

    unshared = served(shared_workload(), n_slots=SLOTS // 2)
    reqs = shared_workload()
    shared = served(reqs, n_slots=SLOTS // 2, prefix_sharing=True)
    n_shared = sum(r.shared_tokens for r in reqs)
    same = shared == unshared
    print(f"[serve-entry] {cfg.name} ref: prefix-shared tokens bitwise "
          f"equal to unshared: {same} ({n_shared} prompt tokens of "
          f"{sum(r.prompt_len for r in reqs)} mapped from live donors' "
          f"pages, {sum(r.shared_tokens > 0 for r in reqs)} of "
          f"{len(reqs)} requests)", flush=True)
    check(n_shared > 0, "no request shared a prefix: the gate is empty")
    check(same, "under the ref impl prefix sharing changes greedy tokens")


def phase_serve_entry(torch, kern, cfg, params):
    """serve() through the entry point: graph vs eager bitwise, launches
    counted through the replays, the dense layout, the static server and
    the trace; tok/s and TTFT p50 of each in turns."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.check_regression import validate_trace
    from repro_torch.serving import SlotEngine, api

    n_req = SERVE_ENTRY["requests"]

    def done(report) -> int:
        """Requests that got all their tokens."""
        if report.static_tokens is not None:
            return sum(t.shape[0] for t in report.static_tokens)
        return sum(len(r.output) == r.max_new_tokens
                   for r in report.requests)

    runs = {"graph": dict(fields={}, kw={}),
            "eager": dict(fields={}, kw={"cuda_graph": False}),
            "dense": dict(fields={"kv_layout": "dense"}, kw={}),
            "static": dict(fields={"static_batching": True}, kw={})}

    def run(name, **fields):
        report = api.serve(serve_options(api, **runs[name]["fields"],
                                         **fields), **runs[name]["kw"])
        torch.cuda.synchronize()
        return report

    t0 = time.perf_counter()
    for name in runs:                    # first-call costs of each path
        run(name, requests=1, gen_len=2)
    print(f"[serve-entry] first calls in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for fn in kern.values():
        fn.launches = 0
    graph = run("graph")
    launches = {name: fn.launches for name, fn in kern.items()}
    steps = graph.summary["steps"]
    want = (steps + SlotEngine.WARMUP_STEPS) * cfg.n_layers
    print(f"[serve-entry] qwen2-1.5b paged graph requests_done="
          f"{graph.summary['requests_done']} steps={steps} launches="
          f"{launches} (expected paged_attention x (steps + "
          f"{SlotEngine.WARMUP_STEPS} warm-up) x {cfg.n_layers} = {want})",
          flush=True)
    check(graph.summary["requests_done"] == n_req and done(graph) == n_req,
          f"graph run finished {done(graph)} of {n_req} requests")
    check(launches["paged_attention"] == want
          and sum(launches.values()) == want,
          f"serve-entry launches {launches}, expected paged_attention x "
          f"{want} and nothing else")
    eager = run("eager")
    same = graph.outputs == eager.outputs
    print(f"[serve-entry] graph tokens bitwise equal to eager: {same}",
          flush=True)
    check(same, "the graph's greedy tokens differ from the eager step's")
    graph_step_matches_eager(torch, cfg, params)
    serving_identities(torch, cfg, params)

    trace = ROOT / "build" / "serve_entry_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    traced = run("graph", trace=str(trace), slo_report=True)
    checks = validate_trace(str(trace))
    print(f"[serve-entry] trace: {len(json.loads(trace.read_text())['traceEvents'])}"
          f" events; " + "; ".join(f"{c}={ok}" for c, ok, _ in checks),
          flush=True)
    check(all(ok for _, ok, _ in checks), f"trace checks {checks}")
    check(done(traced) == n_req, "traced run did not finish")

    # tok/s and TTFT p50 of each path, in turns, median of three
    rows = {name: [] for name in runs}
    for _ in range(3):
        for name in runs:
            report = run(name)
            check(done(report) == n_req, f"{name} run finished "
                  f"{done(report)} of {n_req} requests")
            rows[name].append((report.summary["tok_per_s"],
                               report.summary.get("ttft_p50_s")))
    med = {}
    for name, vals in rows.items():
        tok = statistics.median(v[0] for v in vals)
        ttft = (None if vals[0][1] is None
                else statistics.median(v[1] for v in vals))
        med[name] = tok
        print(f"[serve-entry] {name}: tok/s={tok:.1f} (runs "
              f"{', '.join(f'{v[0]:.1f}' for v in vals)}) ttft_p50_s="
              + ("n/a (static: tokens land at batch end)" if ttft is None
                 else f"{ttft:.4f}"), flush=True)
    print(f"[serve-entry] graph/eager tok/s = "
          f"{med['graph'] / med['eager']:.2f}x", flush=True)
    dense_agree = np.mean([np.mean(np.asarray(graph.outputs[rid])
                                   == np.asarray(toks))
                           for rid, toks in run("dense").outputs.items()])
    print(f"[serve-entry] dense-layout tokens equal to the paged kernel's: "
          f"{dense_agree:.4f} (reported, not gated: the kernel is close to "
          f"the plain attention, not bitwise equal)", flush=True)
    return launches, graph.outputs


def phase_placement(torch, kern, cfg, smi: str):
    """serve() with phase placement: the disaggregated loop (prefill and
    decode slot engines, each replaying its own graph around the paged
    kernel) against the colocated one, bitwise at equal slot counts, with
    the asynchronous and the synchronous hand-off; the hand-off's bytes
    against its snapshots'; launches counted through both engines'
    replays; the trace; auto placement, the device assignment and the
    measured copy rate; tok/s and TTFT p50 in turns."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.check_regression import validate_trace
    from repro_torch.profiling import ProfileCache, cached_link_bw
    from repro_torch.serving import SlotEngine, api

    n_req = SERVE_ENTRY["requests"]
    link_cache = ROOT / "build" / "link_cache.json"
    trace = ROOT / "build" / "placement_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    link_cache.unlink(missing_ok=True)
    disagg = dict(placement="disagg", prefill_engine="torch",
                  decode_engine="torch", prefill_slots=SLOTS)
    runs = {"colocated": {}, "disagg-async": disagg,
            "disagg-sync": dict(disagg, sync_handoff=True)}

    def run(name, **fields):
        report = api.serve(serve_options(api, **dict(runs.get(name, {}),
                                                     **fields)))
        torch.cuda.synchronize()
        check(sum(len(r.output) == r.max_new_tokens for r in report.requests)
              == len(report.requests) == fields.get("requests", n_req),
              f"{name}: not every request finished")
        return report

    t0 = time.perf_counter()
    run("disagg-async", requests=1, gen_len=2)      # first-call costs
    print(f"[placement] first call in {time.perf_counter() - t0:.1f} s",
          flush=True)
    colocated = run("colocated")

    # the counted run, recording each exported snapshot's bytes
    export, sizes = SlotEngine.export_slot, []

    def export_slot(self, s):
        state = export(self, s)
        sizes.append(SlotEngine.state_nbytes(state))
        return state

    SlotEngine.export_slot = export_slot
    try:
        for fn in kern.values():
            fn.launches = 0
        counted = run("disagg-async")
        launches = {name: fn.launches for name, fn in kern.items()}
    finally:
        SlotEngine.export_slot = export
    steps = counted.summary["steps"]
    want = (steps + 2 * SlotEngine.WARMUP_STEPS) * cfg.n_layers
    hand = counted.handoff
    print(f"[placement] disagg-async requests_done="
          f"{counted.summary['requests_done']} steps={steps} (prefill + "
          f"decode engine) launches={launches} (expected paged_attention x "
          f"(steps + 2 x {SlotEngine.WARMUP_STEPS} warm-up) x "
          f"{cfg.n_layers} = {want})", flush=True)
    check(launches["paged_attention"] == want
          and sum(launches.values()) == want,
          f"placement launches {launches}, expected paged_attention x "
          f"{want} and nothing else")
    check(hand["n_handoffs"] == n_req,
          f"{hand['n_handoffs']} hand-offs for {n_req} requests")
    check(hand["bytes_moved"] == sum(sizes) and len(sizes) == n_req,
          f"hand-off bytes {hand['bytes_moved']} against the snapshots' "
          f"{sum(sizes)} ({len(sizes)} snapshots)")
    same = counted.outputs == colocated.outputs
    print(f"[placement] disagg-async tokens bitwise equal to colocated: "
          f"{same}", flush=True)
    check(same, "disagg-async tokens differ from the colocated run's")
    sync = run("disagg-sync")
    same = sync.outputs == colocated.outputs
    print(f"[placement] disagg-sync tokens bitwise equal to colocated: "
          f"{same}", flush=True)
    check(same, "disagg-sync tokens differ from the colocated run's")
    for name, rep in (("disagg-async", counted), ("disagg-sync", sync)):
        h = rep.handoff
        print(f"[placement] {name} hand-off: {h['n_handoffs']} x "
              f"{h['bytes_moved'] / h['n_handoffs']:.0f} B (per hand-off, "
              f"mean), stall_s={h['stall_s']:.6f} overlap_s="
              f"{h['overlap_s']:.6f} ({smi})", flush=True)

    # the side-stream copy of a device assignment (one card: shared), and
    # the measured same-card copy rate
    assigned = run("disagg-async", device_assignment="auto",
                   measure_link_bw=str(link_cache))
    same = assigned.outputs == colocated.outputs
    bw = cached_link_bw(ProfileCache.load(str(link_cache)))
    print(f"[placement] --device-assignment auto (shared card) tokens "
          f"bitwise equal to colocated: {same}; stall_s="
          f"{assigned.handoff['stall_s']:.6f}; measured same-card copy "
          f"rate {bw / 1e9:.2f} GB/s ({smi})", flush=True)
    check(same, "the assigned (side-stream) hand-off changed the tokens")
    check(bw is not None and bw > 0, "no link measurement was recorded")

    auto = run("auto", placement="auto")
    print(f"[placement] --placement auto ({auto.placement['prefill_engine']}"
          f" / {auto.placement['decode_engine']}):\n"
          f"{auto.placement['summary']}", flush=True)
    check(auto.outputs == colocated.outputs,
          "auto placement changed the tokens")

    traced = run("disagg-async", trace=str(trace))
    checks = validate_trace(str(trace), require_handoff=True)
    print(f"[placement] trace: "
          f"{len(json.loads(trace.read_text())['traceEvents'])} events; "
          + "; ".join(f"{c}={ok}" for c, ok, _ in checks), flush=True)
    check(all(ok for _, ok, _ in checks), f"trace checks {checks}")
    check(traced.outputs == colocated.outputs, "the traced run differs")

    # a GEMM over 2 rows may take another route than over 8: reported only
    unequal = run("disagg-async", prefill_slots=2)
    agree = np.mean([np.mean(np.asarray(unequal.outputs[rid])
                             == np.asarray(toks))
                     for rid, toks in colocated.outputs.items()])
    print(f"[placement] unequal pair (2 prefill slots, {SLOTS} decode): "
          f"tokens bitwise equal to colocated: "
          f"{unequal.outputs == colocated.outputs} ({agree:.4f} of tokens; "
          f"reported, not gated)", flush=True)

    # tok/s and TTFT p50 of each path, in turns, median of three
    rows = {name: [] for name in runs}
    for _ in range(3):
        for name in runs:
            rep = run(name)
            rows[name].append((rep.summary["tok_per_s"],
                               rep.summary["ttft_p50_s"]))
    for name, vals in rows.items():
        print(f"[placement] {name}: tok/s="
              f"{statistics.median(v[0] for v in vals):.1f} (runs "
              f"{', '.join(f'{v[0]:.1f}' for v in vals)}) ttft_p50_s="
              f"{statistics.median(v[1] for v in vals):.4f} ({smi})",
              flush=True)
    return launches


def speculation_checks(torch, cfg, params, k: int) -> None:
    """From a live mid-decode state of the paged engine: the verify step's
    logits at each window offset against k+1 sequential plain steps (ref
    impl), and a round whose proposals are rejected at offset 1."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.serving import SlotEngine, SpecPlan
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.request import synthetic_workload
    from repro_torch.serving.speculative import SpeculativeDecoder

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    max_seq = PROMPT + GEN
    pool = KVPool(SLOTS, max_seq, block_size=PAGE)
    eng = SlotEngine(hopper, params, pool, kv_layout="paged")
    for r in synthetic_workload(SLOTS - 1, rate=1e9, vocab=cfg.vocab,
                                prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                seed=6):
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    eng.dispatch(PROMPT + GEN // 4, eng.active)      # a quarter into decode
    live = torch.tensor(eng.active, device="cuda")

    def cloned():
        return {"layers": [{n: a.clone() for n, a in layer.items()}
                           for layer in eng.cache["layers"]],
                "pos": eng.cache["pos"].clone(),
                "block_tables": eng.cache["block_tables"].clone()}

    window = torch.cat([eng._last_tok[:, None], torch.randint(
        0, cfg.vocab, (SLOTS, k), device="cuda", dtype=torch.int32,
        generator=torch.Generator("cuda").manual_seed(7))], dim=1)
    with torch.no_grad():
        multi, _ = T.decode_multi_step_slots_paged(
            eng.params, hopper, cloned(), window, live, max_seq=max_seq,
            advance=False)
        cache = cloned()
        seq = [T.decode_step_slots_paged(eng.params, ref_cfg, cache,
                                         window[:, i:i + 1], live,
                                         max_seq=max_seq)[0][:, 0]
               for i in range(k + 1)]
    rels = [_rel(multi[:, i][live], seq[i][live]) for i in range(k + 1)]
    print(f"[speculation] verify step at pos {PROMPT + GEN // 4}, offsets "
          f"0..{k} against {k + 1} sequential ref steps: max_rel_err "
          + ", ".join(f"{r:.3e}" for r in rels), flush=True)
    check(max(rels) <= DECODE_RTOL, f"verify logits differ from sequential "
          f"steps by {max(rels):.3e} of their largest magnitude")

    # a rejection at offset 1, from one state three times: a round with
    # every proposal corrupted at offset 0 shows the verify's first token
    # g1, one proposing g1 shows its second g2, and one proposing g1 and a
    # token other than g2 must accept 1 and commit 2
    seen = {}

    def override(round_index, proposals):
        p = proposals.copy()
        if round_index == 0:
            p[:, 0] = (p[:, 0] + 1) % cfg.vocab
        else:
            p[:, 0] = seen["g1"]
        if round_index == 2:
            p[:, 1] = (seen["g2"] + 1) % cfg.vocab
        return p

    spec = SpeculativeDecoder(eng, SpecPlan(hopper, eng.params, k=k),
                              propose_override=override,
                              target_params=eng.params)
    mask, pos = eng.active.copy(), eng.steps_done.copy()
    rem = eng.steps_total - eng.steps_done
    plens = np.array([0 if r is None else r.prompt_len for r in eng.slots])
    state = (eng.cache["pos"], eng._last_tok, eng._out_buf)
    saved = [t.clone() for t in state]
    spec.sync_drafts(pos, mask)
    committed = []
    for _ in range(3):
        for t, s in zip(state, saved):
            t.copy_(s)
        committed.append(spec.round(mask, rem)[mask])
        seen.setdefault("g1", np.array(eng._last_tok.cpu()))
        if len(committed) == 2:      # out_buf[x] holds position plen + x
            seen["g2"] = eng._out_buf.cpu().numpy()[
                np.arange(SLOTS), np.maximum(pos - plens + 2, 0)]
    accepted = spec._counts[1].cpu().numpy()[mask]
    print(f"[speculation] rejection at offset 1: committed per slot "
          f"{committed[2].tolist()}, accepted {accepted.tolist()} (offset 0 "
          f"corrupted: {committed[0].tolist()}; g1 proposed: "
          f"{committed[1].tolist()})", flush=True)
    check((committed[0] == 1).all() and (committed[1] >= 2).all(),
          f"rejections at offset 0 / after g1 committed {committed[:2]}")
    check((committed[2] == 2).all() and (accepted == 1).all(),
          f"a rejection at offset 1 committed {committed[2].tolist()}, "
          f"expected 2 per slot")


def phase_speculation(torch, kern, cfg, params, smi: str):
    """serve() with speculative decoding (self-draft, k 2): graph vs eager
    bitwise, the priced fallback against plain bitwise, launches counted
    through the replays, the pool drained; the verify step against
    sequential steps and a rejection at offset 1; tok/s in turns."""
    from repro_torch.serving import SlotEngine, api
    from repro_torch.serving.speculative import DraftEngine

    k = 2
    n_req = SERVE_ENTRY["requests"]
    forced = {"speculate": True, "draft_k": k}
    runs = {"plain": ({}, {}), "spec-graph": (forced, {}),
            "spec-eager": (forced, {"cuda_graph": False}),
            "priced": ({"speculate": True}, {})}

    def run(name, **fields):
        opts, kw = runs[name]
        report = api.serve(serve_options(api, **opts, **fields), **kw)
        torch.cuda.synchronize()
        check(sum(len(r.output) == r.max_new_tokens for r in report.requests)
              == len(report.requests) == fields.get("requests", n_req),
              f"{name}: not every request finished")
        return report

    t0 = time.perf_counter()
    for name in runs:                    # first-call costs of each path
        run(name, requests=2, gen_len=8)
    print(f"[speculation] first calls in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the counted run, recording the target engine's plain steps
    dispatch, plain_steps = SlotEngine.dispatch, []

    def counted_dispatch(self, burst, active_np):
        plain_steps.append(burst)
        return dispatch(self, burst, active_np)

    SlotEngine.dispatch = counted_dispatch
    try:
        for fn in kern.values():
            fn.launches = 0
        graph = run("spec-graph")
        launches = {name: fn.launches for name, fn in kern.items()}
    finally:
        SlotEngine.dispatch = dispatch
    spec = graph.speculation
    rounds, steps = spec["n_rounds"], sum(plain_steps)
    # the draft's k+1 steps and the verify's k+1 plain steps a round, each
    # graph after its eager warm-up (the verify's: one call)
    want = cfg.n_layers * (steps + (k + 1) * (rounds + DraftEngine.WARMUP_ROUNDS)
                           + (k + 1) * (rounds + 1) + SlotEngine.WARMUP_STEPS)
    print(f"[speculation] spec-graph k={k}: {rounds} rounds, "
          f"{spec['n_committed']} committed of {spec['n_proposed']} proposed"
          f" ({spec['n_committed'] / max(rounds, 1):.3f} committed tokens "
          f"per round over {spec['n_proposed'] // max(k * rounds, 1)} "
          f"slots on average), acceptance {spec['acceptance_rate']}, "
          f"{steps} plain-step replays, driver steps "
          f"{graph.summary['steps']}; launches={launches} (expected "
          f"paged_attention x {cfg.n_layers} x ({steps} + {k + 1} x "
          f"({rounds} + {DraftEngine.WARMUP_ROUNDS}) + {k + 1} x ({rounds} + "
          f"1) + {SlotEngine.WARMUP_STEPS}) = {want}) ({smi})", flush=True)
    check(rounds > 0 and spec["engaged"] and spec["forced"],
          f"speculation never engaged: {spec}")
    check(launches["paged_attention"] == want
          and sum(launches.values()) == want,
          f"speculation launches {launches}, expected paged_attention x "
          f"{want} and nothing else")
    pool = graph.pool_stats["kv_pool"]
    check(pool["blocks_in_use"] == 0 and pool["slots_in_use"] == 0,
          f"pages left in use after the run: {pool}")
    eager = run("spec-eager")
    same = graph.outputs == eager.outputs
    print(f"[speculation] spec-graph tokens bitwise equal to spec-eager: "
          f"{same}", flush=True)
    check(same, "the speculative graphs' tokens differ from the eager run's")
    plain = run("plain")
    priced = run("priced")
    decision = priced.speculation["decision"]
    print(f"[speculation] --speculate alone: priced_fallback="
          f"{priced.speculation['priced_fallback']}, acceptance prior "
          f"{priced.speculation['acceptance_prior']} "
          f"({priced.speculation['acceptance_source']}); plain "
          f"{decision['plain_step_s']:.6e} s/token against spec "
          f"{decision['spec_step_s']:.6e} at k={decision['k']} (x"
          f"{decision['projected_speedup']:.4f}); table (k, s/token) "
          f"{decision['table']}", flush=True)
    check(priced.speculation["priced_fallback"] is True
          and not priced.speculation["engaged"],
          f"the self-draft was not priced out: {priced.speculation}")
    check(priced.outputs == plain.outputs,
          "the priced fallback's tokens differ from the plain run's")
    agree = np.mean([np.mean(np.asarray(graph.outputs[rid])
                             == np.asarray(toks))
                     for rid, toks in plain.outputs.items()])
    print(f"[speculation] forced spec tokens bitwise equal to plain: "
          f"{graph.outputs == plain.outputs} ({agree:.4f} of tokens)",
          flush=True)
    check(graph.outputs == plain.outputs,
          "forced speculation's tokens differ from plain decode's")
    speculation_checks(torch, cfg, params, k)

    # tok/s and TTFT p50 of each path, in turns, median of three
    timed = ("plain", "spec-graph", "spec-eager")
    rows = {name: [] for name in timed}
    for _ in range(3):
        for name in timed:
            rep = run(name)
            rows[name].append((rep.summary["tok_per_s"],
                               rep.summary["ttft_p50_s"]))
    for name, vals in rows.items():
        print(f"[speculation] {name}: tok/s="
              f"{statistics.median(v[0] for v in vals):.1f} (runs "
              f"{', '.join(f'{v[0]:.1f}' for v in vals)}) ttft_p50_s="
              f"{statistics.median(v[1] for v in vals):.4f} ({smi})",
              flush=True)
    return launches


def phase_obs(torch, kern, cfg, params, plain_outputs, smi: str):
    """14. The watchdog, latency curves and telemetry feedback through
    serve() on the full-width model, phase 8's workload on the paged kernel
    (every burst synced and timed): a mispriced run the watchdog must
    correct, two feed-cache/persist-curves runs (the second primed), a
    forced speculating run whose rounds the watchdog observes, every one
    with phase 8's graph run's tokens; tok/s with and without the watchdog
    in turns.  serve()'s prefill runs no flash, so the served prompts are
    also prefilled on the flash kernel, each held to chunked as phase 6
    holds its prompt.  Returns the launches by kernel of the serve() runs
    and of that prefill run."""
    import dataclasses
    from repro_torch.core import device_models
    from repro_torch.models import transformer as T
    from repro_torch.obs import PerfWatchdog
    from repro_torch.obs.curves import curve_points_from_cache
    from repro_torch.profiling.bench import dtype_name
    from repro_torch.profiling.cache import ProfileCache
    from repro_torch.serving import api
    from repro_torch.serving import speculative as spec_lib
    from repro_torch.serving.batcher import step_time_model

    n_req = SERVE_ENTRY["requests"]
    total = {name: 0 for name in kern}

    def run(tag, **fields):
        for fn in kern.values():
            fn.launches = 0
        report = api.serve(serve_options(api, **fields))
        torch.cuda.synchronize()
        for name, fn in kern.items():
            total[name] += fn.launches
        done = sum(len(r.output) == r.max_new_tokens for r in report.requests)
        same = report.outputs == plain_outputs
        print(f"[obs] {tag}: requests_done={done} tok/s="
              f"{report.summary['tok_per_s']:.1f} tokens bitwise equal to "
              f"phase 8's graph run: {same}", flush=True)
        check(done == n_req, f"{tag}: {done} of {n_req} requests finished")
        check(same, f"{tag}: tokens differ from phase 8's graph run")
        return report

    # a price 100x the step SLO at 2 tokens pins the budget to 1; the
    # watchdog must see the card is far faster and re-open it
    max_len = SERVE_ENTRY["prompt_len"] + SERVE_ENTRY["gen_len"]
    factor = (100.0 * OBS_STEP_SLO_MS / 1e3 / step_time_model(
        cfg, max_len, 2, device=device_models.get("nvidia-h100")))
    mis = run("misprice", watchdog=True, misprice=factor,
              step_slo_ms=OBS_STEP_SLO_MS)
    rep, adm = mis.watchdog, mis.admission[0]
    print(f"[obs] misprice x{factor:.4g} (step SLO {OBS_STEP_SLO_MS} ms): "
          f"{len(rep['alerts'])} alerts ("
          + ", ".join(f"{a['direction']} ewma={a['ewma_ratio']:.3e} at "
                      f"batch {a['batch']}" for a in rep["alerts"])
          + f"), {len(rep['reprices'])} re-prices ("
          + ", ".join(f"{r['pricing']}: budget {r['token_budget_old']} -> "
                      f"{r['token_budget']}" for r in rep["reprices"])
          + f"); final budget {adm['token_budget']}/{adm['n_slots']} "
          f"({adm['price_source']})", flush=True)
    check(any(a["direction"] == "fast" for a in rep["alerts"]),
          f"misprice: no fast alert {rep['alerts']}")
    check(rep["reprices"] and rep["reprices"][0]["token_budget_old"] == 1,
          f"misprice: the budget was not pinned to 1 and re-priced "
          f"{rep['reprices']}")
    check(adm["token_budget"] == SLOTS, f"misprice: final budget "
          f"{adm['token_budget']}, expected all {SLOTS} slots")

    # telemetry into the profile cache, then a run primed from its curve
    path = ROOT / "build" / "obs_curves_cache.json"
    path.unlink(missing_ok=True)
    curves = [run(f"curves run {i + 1}", feed_cache=str(path),
                  persist_curves=str(path)) for i in range(2)]
    cache = ProfileCache.load(str(path))
    fed = cache.measurements(source="serving-telemetry")
    points = curve_points_from_cache(cache, cfg, kv_len=max_len,
                                     dtype=dtype_name(cfg.compute_dtype))
    sources = [c.admission[0]["price_source"] for c in curves]
    print(f"[obs] curves: {len(fed)} telemetry entries under "
          f"{cache.env['device_name']}; step ms by batch "
          + ", ".join(f"{b}: {t * 1e3:.3f}" for b, t in sorted(
              points.items()))
          + f"; pricing of run 1 {sources[0]}, run 2 {sources[1]}",
          flush=True)
    check(len(points) >= 2 and sources == ["analytic", "cache-curve"],
          f"curves: points {points}, price sources {sources}; expected the "
          f"second run primed from the first run's curve")

    # forced speculation under the watchdog: every round synced, observed
    observed, inside = [], []
    spec_dispatch, observe = spec_lib.spec_dispatch, PerfWatchdog.observe_burst

    def counted_dispatch(*args, **kwargs):
        inside.append(True)
        try:
            return spec_dispatch(*args, **kwargs)
        finally:
            inside.pop()

    def counted_observe(self, *args, **kwargs):
        if inside:
            observed.append(kwargs["steps"])
        return observe(self, *args, **kwargs)

    spec_lib.spec_dispatch = counted_dispatch
    PerfWatchdog.observe_burst = counted_observe
    try:
        spec = run("speculating k 2 under the watchdog", speculate=True,
                   draft_k=2, watchdog=True)
    finally:
        spec_lib.spec_dispatch, PerfWatchdog.observe_burst = (spec_dispatch,
                                                              observe)
    rounds = spec.speculation["n_rounds"]
    print(f"[obs] speculating: {rounds} rounds, {len(observed)} observed "
          f"by the watchdog (steps per round "
          f"{min(observed, default=0):.3f}-{max(observed, default=0):.3f}), "
          f"{len(spec.watchdog['alerts'])} alerts, "
          f"{len(spec.watchdog['reprices'])} re-prices", flush=True)
    check(rounds > 0 and len(observed) == rounds,
          f"speculating: {rounds} rounds, {len(observed)} observed")

    # serve()'s slot prefill runs the plain attention, not flash (as the
    # JAX package's does): the served prompts prefilled on the flash
    # kernel, a prefill run of its own, each held to chunked as phase 6
    hopper = dataclasses.replace(cfg, attention_impl="hopper")
    plain = dataclasses.replace(cfg, attention_impl="chunked")
    for fn in kern.values():
        fn.launches = 0
    prompts = [torch.from_numpy(np.asarray(r.prompt, np.int64))[None].cuda()
               for r in mis.requests]
    with torch.no_grad():
        got = [T.forward(params, hopper, x)[0] for x in prompts]
        torch.cuda.synchronize()
        prefill = {name: fn.launches for name, fn in kern.items()}
        rels = [_rel(g, T.forward(params, plain, x)[0])
                for g, x in zip(got, prompts)]
    del got
    print(f"[obs] flash prefill of the {n_req} served prompts: launches "
          f"{prefill}; logits against chunked's: max_rel_err "
          f"{max(rels):.3e} (limit {PREFILL_RTOL})", flush=True)
    check(prefill["flash_attention"] == n_req * cfg.n_layers
          and sum(prefill.values()) == prefill["flash_attention"],
          f"served prompts' prefill launches {prefill}")
    check(max(rels) <= PREFILL_RTOL, f"served prompts' flash prefill "
          f"differs from chunked by {max(rels):.3e} of its largest logit")

    # tok/s with and without the watchdog (every burst synced), in turns
    rows = {"plain": [], "watchdog": []}
    for _ in range(3):
        rows["plain"].append(run("plain").summary["tok_per_s"])
        rows["watchdog"].append(run("watchdog", watchdog=True)
                                .summary["tok_per_s"])
    for name, vals in rows.items():
        print(f"[obs] {name}: tok/s={statistics.median(vals):.1f} (runs "
              f"{', '.join(f'{v:.1f}' for v in vals)}) ({smi})", flush=True)
    print(f"[obs] launches of the serve() runs {total} (their prefill runs "
          f"no flash); of the served prompts' flash prefill {prefill}",
          flush=True)
    check(total["paged_attention"] > 0, f"obs: launches {total}, expected "
          f"paged > 0")
    return total, prefill


def phase_migration(torch, kern, cfg, params, plain_outputs, smi: str):
    """15. The watchdog on the disaggregated loop through serve() on the
    full-width model, on the paged kernel, prefill and decode slot engines
    of SLOTS each: the decode phase priced on k40-roofline at 1e-6 of its
    cost (--misprice-phase decode), so its stream alerts and re-placement
    over the hosted pair moves decode onto the torch engine, live-migrating
    in-flight slots (replayed there by that engine's graph); the same run
    on one engine (advice only), two feed-cache/persist-curves runs (the
    second primed) and a speculating run (pinned).  Phase 8's 8 requests
    alone give the decode stream too few bursts to alert (the watchdog's
    warm-up, MIGRATION_REQUESTS), so every leg serves MIGRATION_REQUESTS of
    the same generator: the first 8 are phase 8's, and each leg's tokens
    are held to the colocated run of them all, whose first 8 are held to
    phase 8's.  tok/s with and without the watchdog in turns, the watched
    leg under a drift gate nothing reaches (SYNC_DRIFT_GATE).  Returns the
    launches by kernel of the serve() runs."""
    from repro_torch.serving import api

    n_req = MIGRATION_REQUESTS
    n_entry = SERVE_ENTRY["requests"]
    total = {name: 0 for name in kern}
    trace = ROOT / "build" / "migration_trace.json"
    path = ROOT / "build" / "migration_curves_cache.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    disagg = dict(placement="disagg", prefill_engine="torch",
                  decode_engine="k40-roofline", prefill_slots=SLOTS,
                  requests=n_req)
    mispriced = dict(watchdog=True, misprice=MIGRATION_MISPRICE,
                     misprice_phase="decode")
    build = api.build_params
    api.build_params = lambda c, device: params

    def run(tag, want=None, **fields):
        for fn in kern.values():
            fn.launches = 0
        report = api.serve(serve_options(api, **fields))
        torch.cuda.synchronize()
        for name, fn in kern.items():
            total[name] += fn.launches
        done = report.summary["requests_done"]
        dropped = report.summary["requests_dropped"]
        line = (f"[migration] {tag}: requests_done={done} dropped={dropped} "
                f"tok/s={report.summary['tok_per_s']:.1f} paged launches="
                f"{kern['paged_attention'].launches}")
        if want is not None:
            same = report.outputs == want
            line += (f"; tokens bitwise equal to the colocated run's: "
                     f"{same}")
        print(line, flush=True)
        check(done == fields.get("requests", n_entry) and dropped == 0,
              f"{tag}: {done} done, {dropped} dropped")
        check(kern["paged_attention"].launches > 0,
              f"{tag}: the paged kernel was not launched")
        if want is not None:
            check(same, f"{tag}: tokens differ from the colocated run's")
        return report

    def reprices(report) -> str:
        """Each re-price: its phase, pricing, advised decode engine and
        what was actuated (or why not)."""
        out = []
        for r in report.watchdog["reprices"]:
            advice = r.get("placement_advice") or {}
            acted = (f"-> {r['decode_target']} ({r['live_migrations']} "
                     f"moved)" if r.get("actuated")
                     else r.get("reason") or r.get("placement_error")
                     or "kept")
            out.append(f"{r['phase']}/{r['pricing']} advice "
                       f"{advice.get('decode_engine')}: {acted}")
        return "[" + "; ".join(out) + "]"

    try:
        run("first call", **dict(disagg, requests=1, gen_len=2))
        colocated = run("colocated", requests=n_req)
        want = colocated.outputs
        entry_same = {rid: want[rid] for rid in plain_outputs} == plain_outputs
        print(f"[migration] the colocated run's first {n_entry} requests "
              f"bitwise equal to phase 8's graph run: {entry_same}",
              flush=True)
        check(entry_same, "the colocated run's first requests differ from "
              "phase 8's")

        # 1. actuated: the decode stream alerts, decode moves onto the
        # torch engine and in-flight slots live-migrate
        act = run("actuated", want, **disagg, **mispriced, trace=str(trace))
        alerts = act.watchdog["alerts"]
        moves = [e["args"] for e in json.loads(trace.read_text())[
                     "traceEvents"]
                 if e.get("name") == "handoff" and e.get("args", {}).get(
                     "kind") == "live-migration"]
        hand = act.handoff
        print(f"[migration] actuated: {len(alerts)} alerts ("
              + ", ".join(f"{a['phase']} {a['direction']} ewma="
                          f"{a['ewma_ratio']:.3e} at batch {a['batch']}"
                          for a in alerts)
              + f"); re-prices {reprices(act)}; final decode target "
              f"{act.decode_target}", flush=True)
        print(f"[migration] live migrations: {hand['n_live_migrations']} ("
              + ", ".join(f"{m['from']}->{m['to']} remaining "
                          f"{m['remaining_steps']} bytes {m['bytes']} "
                          f"stall_s {m['stall_s']:.6f}" for m in moves)
              + f"); all hand-offs {hand['n_handoffs']} x "
              f"{hand['bytes_moved'] / hand['n_handoffs']:.0f} B (mean), "
              f"stall_s={hand['stall_s']:.6f} ({smi})", flush=True)
        check(any(a["phase"] == "decode" for a in alerts),
              f"actuated: no alert on the decode stream {alerts}")
        check(any(r["actuated"] is True and r["decode_target"] == "prefill"
                  for r in act.watchdog["reprices"]),
              f"actuated: no re-price moved decode onto the prefill engine "
              f"{reprices(act)}")
        check(hand["n_live_migrations"] >= 1
              and len(moves) == hand["n_live_migrations"]
              and all(m["remaining_steps"] > 0 for m in moves),
              f"actuated: live migrations {hand['n_live_migrations']}, "
              f"spans {moves}")

        # 2. one engine for both phases: the decision stays advice
        advice = run("advice only", want, **dict(disagg,
                                                 decode_engine="torch"),
                     **mispriced)
        reps = advice.watchdog["reprices"]
        print(f"[migration] advice only: re-prices {reprices(advice)}; "
              f"decode target {advice.decode_target}", flush=True)
        check(reps and all(r.get("actuated") is False and r.get("reason")
                           == "single-engine placement" for r in reps),
              f"advice only: re-prices {reprices(advice)}")
        check(advice.decode_target == "decode"
              and advice.handoff["n_live_migrations"] == 0,
              f"advice only: decode target {advice.decode_target}, "
              f"{advice.handoff['n_live_migrations']} live migrations")

        # 3. decode-burst telemetry into the profile cache, then a run
        # whose decode batcher is primed from its curve
        path.unlink(missing_ok=True)
        curves = [run(f"curves run {i + 1}", want, **disagg,
                      feed_cache=str(path), persist_curves=str(path))
                  for i in range(2)]
        sources = [[a["price_source"] for a in c.admission] for c in curves]
        print(f"[migration] curves: price sources (prefill, decode) of run "
              f"1 {sources[0]}, run 2 {sources[1]}", flush=True)
        check(sources == [["analytic", "analytic"],
                          ["analytic", "cache-curve"]],
              f"curves: price sources {sources}; expected run 2's decode "
              f"batcher primed from run 1's curve")

        # 4. speculation pins the decode engine: advice only
        spec = run("speculating k 2, mispriced", want, **disagg,
                   **mispriced, speculate=True, draft_k=2)
        reps = spec.watchdog["reprices"]
        print(f"[migration] speculating: {spec.speculation['n_rounds']} "
              f"rounds; re-prices {reprices(spec)}", flush=True)
        check(reps and all(
            r.get("actuated") is False and r.get("reason")
            == "speculative decoding pins the decode engine" for r in reps),
            f"speculating: re-prices {reprices(spec)}")
        check(spec.decode_target == "decode"
              and spec.handoff["n_live_migrations"] == 0,
              "speculating: the decode engine moved")

        # tok/s of the disaggregated loop with and without the watchdog,
        # in turns.  The watched leg's drift gate is one no stream reaches
        # (SYNC_DRIFT_GATE): every burst on both engines is synced and
        # observed, and nothing alerts, re-prices or migrates, so both legs
        # run the same schedule and differ only by the syncs
        rows = {"disagg": [], "disagg watchdog": []}
        for _ in range(3):
            plain = run("disagg", want, **disagg)
            plain_launches = kern["paged_attention"].launches
            rows["disagg"].append(plain.summary["tok_per_s"])
            watched = run("disagg watchdog", want, **disagg, watchdog=True,
                          drift_gate=SYNC_DRIFT_GATE)
            rows["disagg watchdog"].append(watched.summary["tok_per_s"])
            did = (len(watched.watchdog["alerts"]),
                   len(watched.watchdog["reprices"]),
                   watched.handoff["n_live_migrations"])
            print(f"[migration] disagg watchdog (drift gate "
                  f"{SYNC_DRIFT_GATE:g}): alerts {did[0]}, re-prices "
                  f"{did[1]}, live migrations {did[2]}; paged launches "
                  f"{kern['paged_attention'].launches} against "
                  f"{plain_launches} unwatched", flush=True)
            check(did == (0, 0, 0) and watched.decode_target == "decode",
                  f"disagg watchdog: the watched run acted (alerts, "
                  f"re-prices, live migrations) {did}")
            check(kern["paged_attention"].launches == plain_launches,
                  f"disagg watchdog: {kern['paged_attention'].launches} "
                  f"paged launches against {plain_launches} unwatched")
    finally:
        api.build_params = build
    for name, vals in rows.items():
        print(f"[migration] {name}: tok/s={statistics.median(vals):.1f} "
              f"(runs {', '.join(f'{v:.1f}' for v in vals)}) ({smi})",
              flush=True)
    print(f"[migration] launches of the serve() runs {total}", flush=True)
    return total


def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def expert_ms(torch, cfg, layer) -> dict:
    """One decode step's MoE FFN of one layer at the serve shape (8 slots,
    one token each), timed alone (CUDA events, queued): the whole block
    (router, scatter, expert products, gather) and its three batched
    expert products, with their byte bound (every expert's weights read
    once)."""
    from repro_torch.models import moe as moe_lib

    args = cfg.moe_args()
    x = torch.randn((SLOTS, 1, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(9)).to(
        cfg.compute_dtype)
    cap = moe_lib.capacity(args, 1)
    xin = torch.randn((args.n_experts, SLOTS * cap, cfg.d_model),
                      device="cuda").to(cfg.compute_dtype)
    m = layer["mlp"]

    def products():
        h = torch.bmm(xin, m["w_gate"]) * torch.bmm(xin, m["w_up"])
        return torch.bmm(h, m["w_down"])

    weights = sum(m[k].numel() * m[k].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
    with torch.no_grad():
        return {"moe_block_ms": time_ms(torch, lambda: moe_lib.moe_apply(
                    m, x, args, cfg.compute_dtype), queued=True),
                "expert_products_ms": time_ms(torch, products, queued=True),
                "expert_bound_ms": weights / HBM_BW * 1e3}


def step_breakdown(torch, cfg, params, smi: str) -> None:
    """One replayed decode step of the phase-7 workload's shape (7 of 8
    slots live, a quarter into decoding): its device time by torch.profiler
    over 8 replays (each replay of the step's CUDA graph), the paged
    kernel's share, and the MoE expert products
    and whole MoE blocks timed alone at the step's shape (x the layers)."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SlotEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.request import synthetic_workload

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    pool = KVPool(SLOTS, PROMPT + GEN, block_size=PAGE)
    eng = SlotEngine(hopper, params, pool, kv_layout="paged")
    for r in synthetic_workload(SLOTS - 1, rate=1e9, vocab=cfg.vocab,
                                prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                seed=5):
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    eng.dispatch(PROMPT + GEN // 4, eng.active)
    steps = min(8, int((eng.steps_total - eng.steps_done)[eng.active].min()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.dispatch(steps, eng.active)
        torch.cuda.synchronize()
    step_us = attn_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            step_us += ev.self_device_time_total
            if "paged_attention" in ev.key:
                attn_us += ev.self_device_time_total
    step_ms, attn_ms = step_us / steps / 1e3, attn_us / steps / 1e3
    moe = expert_ms(torch, cfg, eng.params["layers"][0])
    n = cfg.n_layers
    experts = moe["expert_products_ms"] * n
    print(f"[families] {cfg.name} one replayed decode step (8 slots, 7 "
          f"live, pos {PROMPT + GEN // 4}): device_ms={step_ms:.4f}; "
          f"expert products {experts:.4f} (alone, x{n} layers; byte bound "
          f"{moe['expert_bound_ms'] * n:.4f}: every expert's weights read "
          f"each step), whole MoE blocks {moe['moe_block_ms'] * n:.4f} "
          f"(alone, x{n}), paged attention kernel {attn_ms:.4f}, the rest "
          f"{step_ms - experts - attn_ms:.4f} ({smi})", flush=True)


def phase_families(torch, kern, smi: str):
    """11. The MoE and recurrent families: phi3.5-MoE at full width (8 of
    32 layers) on the flash and paged kernels, falcon-mamba-7b and
    recurrentgemma-2b at full scale through serve().  Returns the phase's
    launches by kernel."""
    import dataclasses
    from repro_torch.configs import (falcon_mamba_7b, phi35_moe,
                                     recurrentgemma_2b)
    from repro_torch.models import transformer as T
    from repro_torch.serving import api

    total = {name: 0 for name in kern}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    phi = dataclasses.replace(phi35_moe.CONFIG, n_layers=PHI_LAYERS)
    t0 = time.perf_counter()
    params = T.compute_params(T.init_params(phi, seed=0), phi)
    torch.cuda.synchronize()
    print(f"[families] {phi.name} {PHI_LAYERS} of 32 layers at full width: "
          f"{T.count_params(phi):,} parameters "
          f"({T.count_active_params(phi):,} active) from seed 0, bf16 copy "
          f"in {time.perf_counter() - t0:.1f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    add(phase_prefill(torch, kern, phi, params, tag="families"))
    launches, summary, _ = phase_serve(torch, kern, phi, params,
                                       tag="families", speculate=False)
    add(launches)
    print(f"[families] {phi.name} serve: tok/s={summary['tok_per_s']:.1f} "
          f"ttft_p50_s={summary['ttft_p50_s']:.4f} ({smi})", flush=True)
    graph_equals_eager_engine(torch, kern, phi, params, total)
    step_breakdown(torch, phi, params, smi)
    print(f"[families] {phi.name} max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})",
          flush=True)
    check(total["flash_attention"] > 0 and total["paged_attention"] > 0,
          f"{phi.name}: launches {total}, expected flash and paged > 0")
    del params
    _free(torch)

    for cfg, layouts in ((falcon_mamba_7b.CONFIG, ("paged", "dense")),
                         (recurrentgemma_2b.CONFIG, ("dense",))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.compute_params(T.init_params(cfg, seed=0), cfg)
        torch.cuda.synchronize()
        print(f"[families] {cfg.name}: {T.count_params(cfg):,} parameters "
              f"from seed 0, bf16 copy in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if "mamba" in cfg.layer_types():
            forward_ms(torch, cfg, params, smi)
        else:                            # D 256 attention on the kernel
            add(phase_prefill(torch, kern, cfg, params, tag="families"))
        serve_family(torch, kern, api, cfg, params, layouts, total, smi)
        del params
        _free(torch)
    print(f"[families] launches {total}", flush=True)
    return total


def graph_equals_eager_engine(torch, kern, cfg, params, total) -> None:
    """The phase-7 workload through EngineLoop on the paged kernel, each
    step a graph replay and eagerly: the same tokens bit for bit."""
    import dataclasses
    from repro_torch.serving import EngineLoop
    from repro_torch.serving.request import synthetic_workload

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    outs = {}
    for graph in (True, False):
        reqs = synthetic_workload(SLOTS, rate=1e9, vocab=cfg.vocab,
                                  prompt_lens=(PROMPT,), gen_lens=(GEN,),
                                  seed=3)
        loop = EngineLoop(hopper, params, n_slots=SLOTS,
                          max_seq=PROMPT + GEN, block_size=PAGE,
                          cuda_graph=graph)
        for fn in kern.values():
            fn.launches = 0
        loop.warmup()
        summary = loop.run(reqs).summary()
        torch.cuda.synchronize()
        for name, fn in kern.items():
            total[name] += fn.launches
        outs[graph] = [r.output for r in reqs]
        print(f"[families] {cfg.name} {'graph' if graph else 'eager'}: "
              f"tok/s={summary['tok_per_s']:.1f} ttft_p50_s="
              f"{summary['ttft_p50_s']:.4f}", flush=True)
    print(f"[families] {cfg.name} graph tokens bitwise equal to eager: "
          f"{outs[True] == outs[False]}", flush=True)
    check(outs[True] == outs[False], f"{cfg.name}: the graph's greedy "
          "tokens differ from the eager step's")


def forward_ms(torch, cfg, params, smi: str) -> None:
    """forward() on one prompt of two scan chunks: ms per call (host clock
    around a synced call, after one warm call), finite logits."""
    from repro_torch.models import transformer as T

    length = 2 * cfg.scan_chunk
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, length), dtype=np.int64)).cuda()
    with torch.no_grad():
        T.forward(params, cfg, tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.forward(params, cfg, tokens, emit_cache=True)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    chunks = length // cfg.scan_chunk
    print(f"[families] {cfg.name} forward 1x{length} ({chunks} scan chunks "
          f"of {cfg.scan_chunk}): ms={ms:.3f} logits="
          f"{tuple(logits.shape)} ({smi})", flush=True)
    check(logits.shape == (1, length, cfg.vocab)
          and bool(torch.isfinite(logits).all())
          and len(cache["layers"]) == cfg.n_layers,
          f"{cfg.name} forward logits {tuple(logits.shape)} not finite")


def serve_family(torch, kern, api, cfg, params, layouts, total, smi: str):
    """serve() at full scale (the CLI's phase-8 workload), with its weights
    built once (build_params returns this copy): the graph and eager runs
    on the first layout bitwise equal, and every other layout's tokens
    equal to the first's (paged == dense); tok/s and peak memory."""
    arch = {"falcon-mamba-7b": "falcon_mamba_7b",
            "recurrentgemma-2b": "recurrentgemma_2b"}[cfg.name]
    build = api.build_params
    api.build_params = lambda c, device: params
    runs = [(layouts[0], True), (layouts[0], False)] + [
        (layout, True) for layout in layouts[1:]]
    outs = {}
    try:
        api.serve(serve_options(api, arch=arch, requests=1, gen_len=2))
        for layout, graph in runs:
            for fn in kern.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            report = api.serve(serve_options(api, arch=arch,
                                             kv_layout=layout),
                               cuda_graph=graph)
            torch.cuda.synchronize()
            for name, fn in kern.items():
                total[name] += fn.launches
            outs[layout, graph] = report.outputs
            done = sum(len(r.output) == r.max_new_tokens
                       for r in report.requests)
            print(f"[families] {cfg.name} serve {layout} "
                  f"{'graph' if graph else 'eager'}: requests_done="
                  f"{report.summary['requests_done']} tok/s="
                  f"{report.summary['tok_per_s']:.1f} ttft_p50_s="
                  f"{report.summary['ttft_p50_s']:.4f} max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"({smi})", flush=True)
            check(done == SERVE_ENTRY["requests"], f"{cfg.name} {layout}: "
                  f"{done} requests finished")
    finally:
        api.build_params = build
    first = outs[layouts[0], True]
    same = {f"{layout}-{'graph' if graph else 'eager'}": out == first
            for (layout, graph), out in outs.items()}
    print(f"[families] {cfg.name} tokens bitwise equal to the "
          f"{layouts[0]} graph run's: {same}", flush=True)
    check(all(same.values()), f"{cfg.name}: tokens differ across runs "
          f"{same}")


def _fingerprint(torch, params) -> list:
    """Each leaf's float64 sum and sum of magnitudes: a leaf whose values
    change changes them."""
    from repro_torch.tree import tree_leaves
    return [(float(t.double().sum()), float(t.double().abs().sum()))
            for t in tree_leaves(params)]


def train_steps(torch, step, params, opt, err, pipe, n: int):
    """``n`` train steps, each synchronized: (params, opt, err, [(loss,
    gnorm)], [seconds per step])."""
    metrics, seconds = [], []
    for _ in range(n):
        batch = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params, opt, err, metrics, seconds


def flash_backward_gate(torch) -> None:
    """ChunkedAttention's gradients at qwen2's heads against dot
    attention's autograd, fp32: causal, with a window of 96, and unmasked
    (the cross-attention's and the encoder's call) against TRAIN_CROSS_T
    keys, S != T and a short last key chunk."""
    from repro_torch.models import attention as attn_lib

    gen = torch.Generator("cuda").manual_seed(12)
    b, hq, hk, s, d = 2, QWEN2_HEADS[0], QWEN2_HEADS[1], TRAIN_ATTN_S, 128

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, dout = draw(b, hq, s, d), draw(b, hq, s, d)
    for window, causal, t in ((None, True, s), (TRAIN_WINDOW, True, s),
                              (None, False, TRAIN_CROSS_T)):
        k, v = draw(b, hk, t, d), draw(b, hk, t, d)
        grads = {}
        for impl in ("chunked", "dot"):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = attn_lib.attend(*leaves, impl=impl, causal=causal,
                                  window=window, kv_chunk=TRAIN_KV_CHUNK)
            out.backward(dout)
            grads[impl] = [x.grad for x in leaves]
        rels = [_rel(g, w) for g, w in zip(grads["chunked"], grads["dot"])]
        print(f"[train] flash backward (S {s}, T {t}, "
              f"{-(-t // TRAIN_KV_CHUNK)} key chunks, causal {causal}, "
              f"window {window}, fp32) against dot autograd: dq, dk, dv "
              f"max_rel_err " + ", ".join(f"{r:.3e}" for r in rels),
              flush=True)
        check(max(rels) <= TOL["float32"], f"the flash backward differs "
              f"from dot's gradients by {max(rels):.3e} (causal {causal}, "
              f"window {window}, T {t})")


def resume_gate(torch, qwen2) -> None:
    """qwen2-1.5B at full width cut to 2 layers: 6 straight steps against
    3 + save + restore into a fresh state + 3, bitwise."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, schedules
    from repro_torch.tree import tree_paths

    cfg = dataclasses.replace(qwen2, n_layers=2)
    init_opt, update = adamw.make_optimizer(schedules.constant(1e-3),
                                            decay=T.decay_mask(cfg))
    step = make_train_step(cfg, update)
    dc = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    vocab=cfg.vocab)

    def fresh():
        p = T.init_params(cfg, seed=0)
        return p, init_opt(p)

    def run(p, o, pipe, n):
        for _ in range(n):
            p, o, _, _ = step(p, o, None, next(pipe))
        return p, o

    pa, oa = run(*fresh(), SyntheticLM(dc), 6)
    pipe = SyntheticLM(dc)
    pb, ob = run(*fresh(), pipe, 3)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt), 3, {"p": pb, "o": ob},
                    extra={"data": pipe.state()}, keep=1)
    del pb, ob
    pc, oc = fresh()
    _, state, extra = restore_latest(str(ckpt), {"p": pc, "o": oc})
    pipe = SyntheticLM(dc)
    pipe.restore(extra["data"])
    seconds = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    pc, oc = run(state["p"], state["o"], pipe, 3)
    a, c = tree_paths({"p": pa, "o": oa}), tree_paths({"p": pc, "o": oc})
    differ = [p for (p, x), (_, y) in zip(a, c) if not torch.equal(x, y)]
    print(f"[train] {cfg.name} 2 layers at full width: 6 steps against 3 + "
          f"save + restore + 3 ({T.count_params(cfg):,} parameters, save "
          f"and restore {seconds:.1f} s): {len(a) - len(differ)} of "
          f"{len(a)} leaves bitwise equal", flush=True)
    check(not differ and len(a) == len(c), f"resume is not bitwise: "
          f"{['/'.join(p) for p in differ[:5]]}")


def train_cli(torch, first_loss: float) -> None:
    """The train CLI's own code on the card: ``repro_torch.launch.train``'s
    main() at full width and depth (--scale full), 2 steps with a
    checkpoint, then a second invocation to step 3 (--grad-accum 2) that
    restores it.  Step 0's loss must be the train step's (``first_loss``),
    every loss finite, and the second run must resume at step 1."""
    import contextlib
    import io
    import re
    import shutil
    from repro_torch.launch import train

    ckpt = ROOT / "build" / "train_cli_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    common = ["--scale", "full", "--ckpt-dir", str(ckpt), "--ckpt-interval",
              "100", "--log-every", "1"]
    outs = []
    t0 = time.perf_counter()
    for extra in (["--steps", "2"], ["--steps", "3", "--grad-accum", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(common + extra)
        outs.append(buf.getvalue())
        _free(torch)
    seconds = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    step_re = re.compile(r"^step\s+(\d+) loss (\S+) lr \S+ gnorm (\S+)$",
                         re.M)
    logged = [[(int(a), float(b), float(c)) for a, b, c in step_re.findall(o)]
              for o in outs]
    print(f"[train] CLI (--scale full) twice, checkpoint at step 1 "
          f"({seconds:.1f} s): " + " | ".join(" / ".join(line for line in o.splitlines()
                                            if line.strip())
                                for o in outs), flush=True)
    check([s for s, _, _ in logged[0]] == [0, 1]
          and [s for s, _, _ in logged[1]] == [1, 2],
          f"the train CLI logged steps {logged}")
    check(all(np.isfinite(x) for run in logged for _, *m in run for x in m),
          f"the train CLI logged a non-finite loss or gnorm: {logged}")
    check(abs(logged[0][0][1] - first_loss) <= 1e-4,
          f"the CLI's step 0 loss {logged[0][0][1]} is not the train "
          f"step's {first_loss:.4f}")
    check("[restore] resumed at step 1" in outs[1].splitlines()
          and not any(line.startswith("[restore]")
                      for line in outs[0].splitlines()),
          "the train CLI did not resume at step 1 from its checkpoint")
    check(all(o.splitlines()[-1].startswith("done: ") for o in outs),
          "the train CLI did not finish")


def phase_train(torch, kern, smi: str):
    """12. Training on the card: qwen2-1.5B at full width and depth, the
    flash backward, a bitwise resume and the tiny model's learning.
    Returns the phase's launches by kernel (all 0)."""
    from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import _schedule
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, compression, schedules
    from repro_torch.tree import tree_leaves

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    t_phase = time.perf_counter()

    # (a) qwen2-1.5B at full width and depth
    cfg = qwen2
    steps = TRAIN_STEPS + 2 + 1
    init_opt, update = adamw.make_optimizer(_schedule("cosine", steps),
                                            decay=T.decay_mask(cfg))
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0)
    opt = init_opt(params)
    before = _fingerprint(torch, params)
    check(all(t.is_cuda for t in tree_leaves((params, opt))),
          "a parameter or moment is not on the card")
    pipe = SyntheticLM(DataConfig(global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ, vocab=cfg.vocab))
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {T.count_params(cfg):,} parameters in fp32 "
          f"masters from seed 0, AdamW state, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    step = make_train_step(cfg, update)
    params, opt, _, metrics, seconds = train_steps(
        torch, step, params, opt, None, pipe, TRAIN_STEPS)
    params, opt, _, m8, _ = train_steps(
        torch, step, params, opt, compression.init_error(params), pipe, 2)
    params, opt, _, m4, s4 = train_steps(
        torch, make_train_step(cfg, update, grad_accum=4), params, opt,
        None, pipe, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(seconds[-8:]) * 1e3
    n_params, tokens = T.count_params(cfg), TRAIN_BATCH * TRAIN_SEQ
    # least times: a step's 6·N·tokens operations at the bf16 peak; AdamW
    # reads parameters, gradients and both moments and writes three back
    step_bound_ms = 6 * n_params * tokens / BF16_PEAK * 1e3
    adamw_bound_ms = 28 * n_params / HBM_BW * 1e3
    losses = [m for m, _ in metrics + m8 + m4]
    gnorms = [g for _, g in metrics + m8 + m4]
    first_loss = losses[0]
    print(f"[train] {cfg.name} batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{cfg.attention_impl} attention (attn_chunk {cfg.attn_chunk}), "
          f"remat {cfg.remat}: ms/step={ms:.2f} (median of steps "
          f"{TRAIN_STEPS - 7}-{TRAIN_STEPS}; first {seconds[0] * 1e3:.1f}) "
          f"tokens/s={TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} "
          f"peak_memory_gib={peak:.2f}; int8 steps {m8}, grad_accum 4 step "
          f"{s4[0] * 1e3:.1f} ms {m4} ({smi})", flush=True)
    print(f"[train] losses {[round(x, 4) for x in losses]} gnorms "
          f"{[round(x, 3) for x in gnorms]}; bounds: step "
          f"{step_bound_ms:.3f} ms (operations, 6 x {n_params:,} x {tokens} "
          f"at {BF16_PEAK / 1e12:.0f} TFLOP/s), AdamW {adamw_bound_ms:.3f} "
          f"ms (bytes, 28 x {n_params:,} at {HBM_BW / 1e12:.2f} TB/s)",
          flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite loss or gradient norm: {losses}, {gnorms}")
    after = _fingerprint(torch, params)
    still = [i for i, (x, y) in enumerate(zip(before, after)) if x == y]
    check(not still and int(opt.step) == steps,
          f"{len(still)} parameter leaves did not move; step {int(opt.step)}")
    check(all(t.is_cuda for t in tree_leaves((params, opt))),
          "a parameter or moment left the card")
    # where a step's time goes: one whole step, then the optimizer alone
    batch = next(pipe)
    device_profile(torch, lambda: step(params, opt, None, batch),
                   "train step")
    _, grads = loss_and_grads(params, cfg, batch)
    device_profile(torch, lambda: update(grads, opt, params), "train adamw")
    del params, opt, step, metrics, grads
    _free(torch)

    # (b) the flash backward, (c) a bitwise resume
    flash_backward_gate(torch)
    resume_gate(torch, qwen2)
    _free(torch)

    # (d) the JAX package's tiny config learns the bigram data
    tiny = T.ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=64, scan_chunk=16,
                         attention_impl="dot", remat=False)
    init_opt, update = adamw.make_optimizer(
        schedules.cosine_schedule(1e-2, 10, 150), decay=T.decay_mask(tiny))
    params = T.init_params(tiny, seed=0)
    params, _, _, metrics, seconds = train_steps(
        torch, make_train_step(tiny, update), params, init_opt(params), None,
        SyntheticLM(DataConfig(global_batch=8, seq_len=32, vocab=64)), 150)
    losses = [m for m, _ in metrics]
    print(f"[train] tiny (2 layers, d 64, vocab 64) on bigram data, 150 "
          f"steps: loss {losses[0]:.4f} -> min of the last 10 "
          f"{min(losses[-10:]):.4f} ({statistics.median(seconds) * 1e3:.2f}"
          f" ms/step)", flush=True)
    check(losses[0] > 3.5 and min(losses[-10:]) < losses[0] - 0.8,
          f"the tiny model did not learn: {losses[::15]}")

    # (e) the train CLI's own code: full width and depth, checkpoint,
    # resume
    train_cli(torch, first_loss)
    _free(torch)

    # (f) no hand-written kernel trains
    launches = {name: fn.launches for name, fn in kern.items()}
    print(f"[train] launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(not any(launches.values()), f"training launched {launches}: no "
          "kernel of the port has a backward")
    return launches


def cross_prefill(torch, kern, cfg, params, extras, length: int, smi: str):
    """forward() of a cross-attention model on one prompt of ``length``
    tokens with its front end's features (``extras``), the flash kernel on:
    one launch per self-attention, cross-attention and encoder layer, the
    logits within PREFILL_RTOL of the "chunked" impl's, each flash call
    within it of "chunked" on its own inputs.  Returns the launches."""
    import dataclasses
    from repro_torch.models import transformer as T

    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, length), dtype=np.int64)).cuda()
    hopper = dataclasses.replace(cfg, attention_impl="hopper")
    plain = dataclasses.replace(cfg, attention_impl="chunked")
    calls = (cfg.layer_types().count("attn") * (2 if cfg.encoder_decoder
                                                 else 1)
             + cfg.layer_types().count("xattn")
             + (cfg.enc_layers if cfg.encoder_decoder else 0))
    with torch.no_grad():
        T.forward(params, hopper, tokens, **extras)     # first-call costs
        torch.cuda.synchronize()
        for fn in kern.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits, cache = T.forward(params, hopper, tokens, emit_cache=True,
                                  **extras)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {name: fn.launches for name, fn in kern.items()}
        t0 = time.perf_counter()
        want, _ = T.forward(params, plain, tokens, **extras)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dot, _ = T.forward(params, dataclasses.replace(
            cfg, attention_impl="dot"), tokens, **extras)
        with ShadowAttention(torch) as shadow:
            T.forward(params, hopper, tokens, **extras)
    rel, plain_rel = _rel(logits, want), _rel(dot, want)
    t_cross = cache["cross"].shape[1]
    print(f"[cross] {cfg.name} forward 1x{length} against {t_cross} "
          f"cross positions: hopper ms={ms:.3f} chunked_ms={plain_ms:.3f} "
          f"logits={tuple(logits.shape)} max_rel_err={rel:.3e} (dot vs "
          f"chunked: {plain_rel:.3e}); each flash call against chunked on "
          f"its inputs: max_rel_err={max(shadow.rels):.3e} over "
          f"{len(shadow.rels)} calls; launches={launches} "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})",
          flush=True)
    check(logits.shape == (1, length, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} logits {tuple(logits.shape)} not finite")
    check(launches["flash_attention"] == calls
          and sum(launches.values()) == calls,
          f"{cfg.name} forward launches {launches}, expected "
          f"flash_attention x {calls} and nothing else")
    check(rel <= PREFILL_RTOL, f"{cfg.name} logits differ from the chunked "
          f"impl by {rel:.3e} of their largest magnitude")
    check(len(shadow.rels) == calls and max(shadow.rels) <= PREFILL_RTOL,
          f"{cfg.name}: a flash call differs from chunked on its inputs by "
          f"{max(shadow.rels):.3e}")
    return launches


def cross_serve(torch, kern, cfg, params, rows, max_seq: int, smi: str):
    """Phase 7's workload (8 requests, prompt 128, 32 new tokens) through
    EngineLoop on the paged kernel, each slot's cross row ``rows[s]``
    written in place before the run: paged launches once per self-attention
    layer and step (the decode steps' cross-attention is one query: plain
    ``dot``, as in the JAX package); graph == eager, paged == dense under
    "ref", and the disaggregated loop (8 prefill and 8 decode slots: the
    decode engine's rows are zeros, so the snapshot must carry each row) ==
    colocated, bitwise, with the hand-off's bytes those of its snapshots,
    each holding its cross row.  Returns the launches."""
    import dataclasses
    from repro_torch.serving import (DisaggregatedEngineLoop, EngineLoop,
                                     SlotEngine)
    from repro_torch.serving.request import synthetic_workload

    hopper = dataclasses.replace(cfg, paged_attention_impl="hopper")
    ref_cfg = dataclasses.replace(cfg, paged_attention_impl="ref")
    n_attn = cfg.layer_types().count("attn")
    total = {name: 0 for name in kern}

    def workload(n=SLOTS, prompt=PROMPT, gen=GEN, seed=3):
        return synthetic_workload(n, rate=1e9, vocab=cfg.vocab,
                                  prompt_lens=(prompt,), gen_lens=(gen,),
                                  seed=seed)

    def run(c, reqs, disagg=False, **kw):
        """Serve ``reqs`` on a new loop whose (prefill) engine holds
        ``rows``, captured before the counts are set to 0: (summary,
        launches, loop)."""
        if disagg:
            loop = DisaggregatedEngineLoop(
                c, params, n_prefill_slots=SLOTS, n_decode_slots=SLOTS,
                max_seq=max_seq, block_size=PAGE, **kw)
            loop.prefill.cache["cross"].copy_(rows)
        else:
            loop = EngineLoop(c, params, n_slots=SLOTS, max_seq=max_seq,
                              block_size=PAGE, **kw)
            loop.engine.cache["cross"].copy_(rows)
        loop.warmup()
        torch.cuda.synchronize()
        for fn in kern.values():
            fn.launches = 0
        summary = loop.run(reqs).summary()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kern.items()}
        for name, n in launches.items():
            total[name] += n
        check(summary["requests_done"] == len(reqs)
              and all(len(r.output) == r.max_new_tokens for r in reqs),
              f"{cfg.name}: {summary['requests_done']} of {len(reqs)} "
              f"requests done")
        return summary, launches, loop

    def tokens(reqs):
        return [r.output for r in reqs]

    run(hopper, workload(1, 4, 2, 9))                  # first-call costs
    torch.cuda.reset_peak_memory_stats()
    graph = workload()
    summary, launches, _ = run(hopper, graph)
    steps = summary["steps"]
    print(f"[cross] {cfg.name} serve (paged kernel, graph): requests_done="
          f"{summary['requests_done']} steps={steps} tok/s="
          f"{summary['tok_per_s']:.1f} ttft_p50_s={summary['ttft_p50_s']:.4f}"
          f" launches={launches} max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})",
          flush=True)
    check(launches["paged_attention"] == steps * n_attn > 0
          and sum(launches.values()) == launches["paged_attention"],
          f"{cfg.name} serve launches {launches}, expected paged_attention "
          f"x {steps} steps x {n_attn} layers and nothing else")
    eager = workload()
    eager_summary, _, _ = run(hopper, eager, cuda_graph=False)
    paged_ref, dense_ref = workload(), workload()
    run(ref_cfg, paged_ref)
    run(ref_cfg, dense_ref, kv_layout="dense")
    export, sizes, cross_bytes = SlotEngine.export_slot, [], []

    def export_slot(self, s):
        state = export(self, s)
        sizes.append(SlotEngine.state_nbytes(state))
        cross_bytes.append(0 if state["cross"] is None
                           else int(state["cross"].nbytes))
        return state

    SlotEngine.export_slot = export_slot
    try:
        dis = workload()
        dis_summary, dis_launches, loop = run(hopper, dis, disagg=True)
    finally:
        SlotEngine.export_slot = export
    moved = loop.handoff.bytes_moved
    same = {"graph==eager": tokens(graph) == tokens(eager),
            "paged==dense (ref)": tokens(paged_ref) == tokens(dense_ref),
            "disagg==colocated": tokens(dis) == tokens(graph)}
    print(f"[cross] {cfg.name} eager: tok/s={eager_summary['tok_per_s']:.1f}"
          f" ttft_p50_s={eager_summary['ttft_p50_s']:.4f}; disagg (8 + 8 "
          f"slots): tok/s={dis_summary['tok_per_s']:.1f} ttft_p50_s="
          f"{dis_summary['ttft_p50_s']:.4f} steps={dis_summary['steps']} "
          f"launches={dis_launches}, {len(sizes)} hand-offs moving {moved} "
          f"B, {sum(cross_bytes)} B of them cross rows ({smi})", flush=True)
    print(f"[cross] {cfg.name} tokens bitwise equal: {same}; hopper against "
          f"ref: {_token_agreement(graph, paged_ref):.4f} of tokens "
          f"(reported, not gated)", flush=True)
    check(all(same.values()), f"{cfg.name}: {same}")
    row_bytes = rows[0].numel() * rows.element_size()
    check(moved == sum(sizes) and len(sizes) == SLOTS
          and cross_bytes == [row_bytes] * SLOTS,
          f"{cfg.name} hand-off moved {moved} B against the snapshots' "
          f"{sum(sizes)} ({len(sizes)} snapshots, cross rows {cross_bytes})")
    check(dis_launches["paged_attention"] == dis_summary["steps"] * n_attn,
          f"{cfg.name} disagg launches {dis_launches}")
    return total


def cross_train(torch, cfg, smi: str) -> None:
    """CROSS_TRAIN_STEPS train steps at the train CLI's defaults (the
    cosine schedule at 3e-3, batch 8 x 128, "chunked" attention) with the
    data pipeline's front-end stub: every loss and gradient norm finite,
    every parameter leaf moved."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _schedule
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    init_opt, update = adamw.make_optimizer(
        _schedule("cosine", CROSS_TRAIN_STEPS), decay=T.decay_mask(cfg))
    params = T.init_params(cfg, seed=0)
    opt = init_opt(params)
    before = _fingerprint(torch, params)
    pipe = SyntheticLM(DataConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        frontend=cfg.frontend, d_model=cfg.d_model, img_seq=cfg.img_seq,
        enc_len=TRAIN_SEQ))
    params, opt, _, metrics, seconds = train_steps(
        torch, make_train_step(cfg, update), params, opt, None, pipe,
        CROSS_TRAIN_STEPS)
    after = _fingerprint(torch, params)
    still = [i for i, (x, y) in enumerate(zip(before, after)) if x == y]
    print(f"[cross] {cfg.name} train: {CROSS_TRAIN_STEPS} steps of batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} with {TRAIN_SEQ} frames, "
          f"{cfg.attention_impl} attention, grad_accum {cfg.grad_accum}: "
          f"(loss, gnorm) {[(round(a, 4), round(b, 3)) for a, b in metrics]}"
          f" ms/step {[round(s * 1e3, 1) for s in seconds]} "
          f"peak_memory_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" ({smi})", flush=True)
    check(all(np.isfinite(metrics).flatten()), f"{cfg.name}: non-finite "
          f"loss or gradient norm {metrics}")
    check(not still, f"{cfg.name}: {len(still)} parameter leaves did not "
          "move")
    del params, opt
    _free(torch)


def phase_cross(torch, kern, smi: str):
    """13. The encoder-decoder and gated cross-attention: seamless-m4t-
    medium at full width and depth, llama-3.2-vision at full width cut to
    one pattern unit.  Returns the phase's launches by kernel."""
    import dataclasses
    from repro_torch.configs import llama32_vision_90b, seamless_m4t_medium
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_paths

    total = {name: 0 for name in kern}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    def build(cfg):
        """The bf16 parameters from seed 0; (params, the count of their
        leaves but the norms, which count_params leaves out)."""
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.compute_params(T.init_params(cfg, seed=0), cfg)
        torch.cuda.synchronize()
        n = sum(t.numel() for path, t in tree_paths(params)
                if not (path[-1].startswith("ln")
                        or path[-1].endswith("norm")))
        print(f"[cross] {cfg.name} ({cfg.n_layers} layers"
              + (f" + {cfg.enc_layers} encoder" if cfg.encoder_decoder
                 else "") + f", d {cfg.d_model}): {n:,} parameters but the "
              f"norms from seed 0 (count_params {T.count_params(cfg):,}), "
              f"bf16 copy in {time.perf_counter() - t0:.1f} s", flush=True)
        return params, n

    gen = torch.Generator("cuda").manual_seed(13)

    def feats(cfg, b, t):
        return torch.randn((b, t, cfg.d_model), generator=gen,
                           device="cuda")

    # (a) seamless-m4t-medium: its tree holds count_params' parameters
    # besides the norms (count_params is the JAX package's count:
    # tests/test_torch_cross.py)
    cfg = seamless_m4t_medium.CONFIG
    params, n = build(cfg)
    check(n == T.count_params(cfg), f"{cfg.name}: {n} parameters, "
          f"count_params {T.count_params(cfg)}")
    add(cross_prefill(torch, kern, cfg, params,
                      {"enc_inputs": feats(cfg, 1, CROSS_FRAMES)},
                      CROSS_PROMPT, smi))
    for fn in kern.values():
        fn.launches = 0
    with torch.no_grad():
        rows = T.encode(params, dataclasses.replace(
            cfg, attention_impl="hopper"), feats(cfg, SLOTS, CROSS_FRAMES))
    add({name: fn.launches for name, fn in kern.items()})
    add(cross_serve(torch, kern, cfg, params, rows, CROSS_MAX_SEQ, smi))
    del params, rows
    cross_train(torch, cfg, smi)

    # (b) llama-3.2-vision at full width, one pattern unit, gates set
    cfg = dataclasses.replace(llama32_vision_90b.CONFIG,
                              n_layers=VISION_LAYERS)
    params, _ = build(cfg)
    for layer in params["layers"]:
        for gate in ("gate_attn", "gate_mlp"):
            if gate in layer:
                layer[gate].fill_(VISION_GATE)
    add(cross_prefill(torch, kern, cfg, params,
                      {"img_embeds": feats(cfg, 1, cfg.img_seq)},
                      PREFILL_TOKENS, smi))
    rows = feats(cfg, SLOTS, cfg.img_seq).to(cfg.compute_dtype)
    add(cross_serve(torch, kern, cfg, params, rows, PROMPT + GEN, smi))
    print(f"[cross] {cfg.name} max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})",
          flush=True)
    del params, rows
    _free(torch)
    print(f"[cross] launches {total}", flush=True)
    check(total["flash_attention"] > 0 and total["paged_attention"] > 0,
          f"cross launches {total}, expected flash and paged > 0")
    return total


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         "from a checkout of the repository")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, the kernels are built "
          "for sm_90a")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()} capability {cap}; "
          f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}", flush=True)

    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch.core.layer_model import alexnet_full_spec
    from repro_torch.kernels import _build, ref
    from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN2
    from repro_torch.kernels import (conv2d, flash_attention, lrn, matmul,
                                     paged_attention, pooling)
    from repro_torch.models import transformer as T
    modules = {"matmul": (matmul, "matmul_cuda"),
               "conv2d": (conv2d, "conv2d_cuda"),
               "pool": (pooling, "pool_cuda"), "lrn": (lrn, "lrn_cuda"),
               "paged_attention": (paged_attention, "paged_attention_cuda"),
               "flash_attention": (flash_attention, "flash_attention_cuda")}
    kern = {name: getattr(mod, fn) for name, (mod, fn) in modules.items()}
    sources = {name: mod.SOURCE for name, (mod, _) in modules.items()}

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    net = alexnet_full_spec()
    per_kernel, layer_ms = phase_kernels(torch, F, ref, kern, net)

    # 4. the main path, then 4b. its measured (profile-then-offload) plan
    launches, by_plan, cnn_params, images, plans, acts_torch, probs_torch = \
        phase_main(torch, kern, net, layer_ms)
    measured_launches = phase_measured(torch, kern, net, cnn_params, images,
                                       plans, acts_torch, probs_torch)
    del cnn_params, images, plans, acts_torch, probs_torch

    # 5. the attention kernels against their plain versions
    lm = phase_lm_kernels(torch, F, ref, kern)

    # 6-10. qwen2-1.5B at full width: prefill, serving, the serve entry,
    # phase placement, speculative decoding
    t0 = time.perf_counter()
    params = T.compute_params(T.init_params(QWEN2, seed=0), QWEN2)
    torch.cuda.synchronize()
    print(f"[qwen2] {T.count_params(QWEN2):,} parameters from seed 0, "
          f"bf16 copy in {time.perf_counter() - t0:.1f} s", flush=True)
    prefill_launches = phase_prefill(torch, kern, QWEN2, params)
    serve_launches, _, _ = phase_serve(torch, kern, QWEN2, params)
    entry_launches, entry_outputs = phase_serve_entry(torch, kern, QWEN2,
                                                      params)
    # 9. phase placement and disaggregated serving through the entry point
    placement_launches = phase_placement(torch, kern, QWEN2, smi)
    # 10. speculative decoding through the entry point
    spec_launches = phase_speculation(torch, kern, QWEN2, params, smi)
    # 14. the watchdog, curves and telemetry feedback (on these weights)
    obs_launches, obs_prefill_launches = phase_obs(torch, kern, QWEN2,
                                                   params, entry_outputs, smi)
    # 15. the watchdog's re-placement and live migration, disaggregated
    migration_launches = phase_migration(torch, kern, QWEN2, params,
                                         entry_outputs, smi)
    del params
    # 11. the MoE and recurrent families
    family_launches = phase_families(torch, kern, smi)
    # 12. training
    train_launches = phase_train(torch, kern, smi)
    # 13. the encoder-decoder and gated cross-attention
    cross_launches = phase_cross(torch, kern, smi)
    by_phase = {"alexnet": launches, "measured": measured_launches,
                "prefill": prefill_launches, "serve": serve_launches,
                "serve_entry": entry_launches,
                "placement": placement_launches,
                "speculation": spec_launches, "families": family_launches,
                "train": train_launches, "cross": cross_launches,
                "obs": obs_launches, "migration": migration_launches,
                "served_prompts_prefill": obs_prefill_launches}
    home = {"flash_attention": "prefill", "paged_attention": "serve_entry"}

    rows = []
    for name in kern:
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
               "replaces": REPLACES[name],
               "launches": by_phase[home.get(name, "alexnet")][name],
               "launches_by_phase": {ph: n[name]
                                     for ph, n in by_phase.items()}}
        if name in home:        # per call x the 28 layers of one forward/step
            case = lm[name]
            row.update(
                max_abs_err=case["max_abs_err"],
                **{k: case[k] * QWEN2.n_layers for k in
                   ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                    "library_device_ms")},
                bound_by=case["bound_by"])
        else:
            agg = per_kernel[name]
            row.update(
                launches_by_plan={plan: n[name]
                                  for plan, n in by_plan.items()},
                max_abs_err=agg["max_abs_err"], ms=agg["ms"],
                plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
                bound_by=("operations" if agg["t_ops"] > agg["t_bytes"]
                          else "bytes"),
                library_ms=agg["library_ms"], device_ms=agg["device_ms"],
                library_device_ms=agg["library_device_ms"])
            if agg["cold_cases"] == agg["main_cases"]:   # all bytes-bound
                row.update(cold_device_ms=agg["cold_device_ms"],
                           library_cold_device_ms=agg[
                               "library_cold_device_ms"])
        rows.append(row)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
