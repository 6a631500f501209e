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
             serving batch and at the edge shapes of tests/test_kernels.py;
             prints the error, the kernel's median time (CUDA events, warm
             L2, after warm-up), the plain version's and one PyTorch library
             call's times, and the least time the card could take (bytes
             over 3.35 TB/s or operations over the dtype's peak, the larger;
             a convolution counts the operations of the cheapest of direct,
             Winograd and FFT, see conv_ops).  At AlexNet's shapes no
             measured time may be below that bound.
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
5. lm-kernels — holds the paged- and flash-attention kernels against their
             plain versions in bf16 at qwen2-1.5B's head shapes (12 query
             heads, 2 kv heads, head_dim 128): the serve phase's decode
             shape and 8 slots at positions spread over 0..2047 (pages of
             16, a boundary page, an inactive slot), and prefill at batch
             1-4, 512 and 2048 tokens; times each beside its plain version,
             a library yardstick (index_select gather + SDPA for paged, SDPA
             on repeated KV heads for flash) and its bound.
6. prefill — forward() of the full-width qwen2-1.5B (28 layers, random
             weights from a seed, bf16 compute) on one 512-token prompt
             with attention_impl "hopper": the flash kernel must launch once
             per layer, and the logits must agree with the same port's
             "chunked" impl within PREFILL_RTOL of their largest magnitude.
             Prints ms per forward.
7. serve   — EngineLoop.run of 8 requests (prompt 128, 32 new tokens,
             8 slots, pages of 16) on the same model with the paged kernel;
             the paged kernel must launch, every request must finish.
             Holds one decode step's logits against the "ref" impl
             (DECODE_RTOL), serves the same requests with "ref" as well and
             reports tok/s, TTFT p50 and the greedy-token agreement of the
             two runs (reported, not gated: the kernel is close to the plain
             version, not bitwise equal).

Every main-path phase (4, 6, 7) sets every kernel's launch count to 0 just
before it and reads them all just after.  The last line is {"ok": true,
"device": {...}}; the line before it holds the card's name and power limit,
and the one before that the per-kernel JSON.  For the AlexNet kernels its
times are summed over the layers a kernel runs in one forward of the kernel
plan at batch 64 and its launches are those of phase 4 (per plan under
"launches_by_plan"); for the attention kernels the times are summed over
the 28 layers of one prefill forward (flash) or one decode step of the serve
phase (paged), at the shapes those phases give them, and the launches are
those of phase 6 (flash) and 7 (paged).  "launches_by_phase" gives every
kernel's count in every main-path phase.
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
TOL = {"float32": 2e-4, "bfloat16": 5e-2}               # tests/test_kernels.py
PROB_RTOL, PROB_ATOL = 2e-3, 2e-4               # tests/test_core_cnnlab.py
LAYER_RTOL, LOGP_ATOL = 3e-5, 2e-4       # ~10x the card's 2.8e-6, 1.5e-5
# bf16 through 28 layers of random weights: the kernel impl's logits against
# the plain impl's, relative to their largest magnitude; ~2.5x the 3.9e-2
# (prefill) and 4.1e-2 (one decode step) measured on the card, the size the
# two plain prefill impls (dot, chunked) differ by as well
PREFILL_RTOL, DECODE_RTOL = 0.1, 0.1
PROMPT, GEN, SLOTS, PAGE = 128, 32, 8, 16            # the serve phase
CNN_KERNELS = ("matmul", "conv2d", "pool", "lrn")
PREFILL_TOKENS = 512
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


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times after warm-up (L2 left warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(flops: float, n_bytes: float, dtype: str):
    t_ops = flops / (FP32_PEAK if dtype == "float32" else BF16_PEAK)
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
    library_fn) per checked shape; main_path marks AlexNet's layers at the
    serving batch."""
    from repro_torch.core.engines import param_shapes

    def t(shape, dtype="float32", scale=1.0):
        a = torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).cuda()
        return a.to(getattr(torch, dtype))

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
            (lambda: torch.mm(x, w))))

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
            lambda: F.conv2d(x_cl, w_cl, b, stride=stride, padding=pad)))

    def pool_case(label, n, hw, c, win, stride, pool_type, dtype, main):
        x = t((n, hw, hw, c), dtype)
        ohw = (hw - win) // stride + 1
        plain = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
        lib = F.max_pool2d if pool_type == "max" else F.avg_pool2d
        cases.append((
            "pool", label, dtype, main, n * ohw * ohw * c * win * win,
            nbytes(x) + n * ohw * ohw * c * x.element_size(),
            lambda: kern["pool"](x, window=win, stride=stride,
                                 pool_type=pool_type),
            lambda: plain(x, window=win, stride=stride),
            lambda: lib(x.permute(0, 3, 1, 2), win, stride)))

    def lrn_case(label, shape, local, dtype, main):
        x = t(shape, dtype)
        cases.append((
            "lrn", label, dtype, main, x.numel() * (2 * local + 4),
            2 * nbytes(x),
            lambda: kern["lrn"](x, local_size=local),
            lambda: ref.lrn_ref(x, local_size=local),
            lambda: F.local_response_norm(x.permute(0, 3, 1, 2), local,
                                          alpha=1e-4, beta=0.75, k=2.0)))

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
    # edge shapes of tests/test_kernels.py
    for dtype in ("float32", "bfloat16"):
        matmul_case("unaligned", 100, 300, 70, dtype, False, bias=False)
        matmul_case("fc6-row", 1, 9216, 4096, dtype, False, bias=False)
        conv_case("conv1-reduced", 2, 12, 3, 8, 11, 4, 2, dtype, False)
        conv_case("5x5-s2", 2, 24, 3, 16, 5, 2, 2, dtype, False)
        pool_case("max-13", 2, 13, 8, 3, 2, "max", dtype, False)
        lrn_case("c7", (2, 7, 7, 7), 5, dtype, False)
    for act in ("sigmoid", "tanh"):
        matmul_case(f"epilogue-{act}", 64, 96, 48, "float32", False, act)
    pool_case("avg-13", 2, 13, 8, 3, 2, "avg", "float32", False)
    pool_case("avg-9-s3", 2, 9, 3, 3, 3, "avg", "float32", False)
    lrn_case("c16-n3", (2, 7, 7, 16), 3, "float32", False)
    return cases


def phase_kernels(torch, F, ref, kern, net):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    per_kernel = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                         "library_ms": 0.0, "bound_ms": 0.0,
                         "t_ops": 0.0, "t_bytes": 0.0}
                  for name in CNN_KERNELS}
    layer_ms = {}       # AlexNet layer -> (kernel ms, plain ms) at BATCH
    failed = []
    for (name, label, dtype, main, flops, n_bytes, fn, plain,
         library) in kernel_cases(torch, F, ref, kern, net, rng):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = got.shape == want.shape and torch.allclose(
            got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        # the library yardstick is timed at the main path's shapes only
        lib_ms = time_ms(torch, library) if main else float("nan")
        bound_ms, bound_by = bound(flops, n_bytes, dtype)
        print(f"[kernels] {name:<6} {label:<15} {dtype:<8} "
              f"out={tuple(got.shape)} max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
              f" launches={kern[name].launches}", flush=True)
        if not ok:
            failed.append(f"{name} {label} {dtype}: max_abs_err {err:.3e}")
        if main and min(ms, plain_ms, lib_ms) < bound_ms:
            failed.append(f"{name} {label}: a time below the bound "
                          f"{bound_ms:.4f} ms ({ms:.4f}, {plain_ms:.4f}, "
                          f"{lib_ms:.4f}): the bound counts too much work")
        if main:
            layer_ms[label] = (ms, plain_ms)
            agg = per_kernel[name]
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms
            agg["library_ms"] += lib_ms
            agg["bound_ms"] += bound_ms
            fp = FP32_PEAK if dtype == "float32" else BF16_PEAK
            agg["t_ops"] += flops / fp
            agg["t_bytes"] += n_bytes / HBM_BW
    check(not failed, "kernel checks failed: " + "; ".join(failed))
    return per_kernel, layer_ms


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
    kernel_of = {"conv": "conv2d", "norm": "lrn", "pool": "pool",
                 "fc": "matmul"}

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
                    want[kernel_of[a.spec.kind]] += N_BATCHES
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

    n_cls = net.layers[-1].k_o
    for label in ("default", "hopper", "torch"):
        for p in probs[label]:
            check(p.shape == (BATCH, n_cls) and bool(torch.isfinite(p).all()),
                  f"plan {label}: output {tuple(p.shape)} not finite "
                  f"({BATCH}, {n_cls})")
            check(torch.allclose(p.sum(-1), torch.ones(BATCH, device=p.device),
                                 rtol=1e-5, atol=0),
                  f"plan {label}: probability rows do not sum to 1")
    for label in ("default", "hopper"):
        rel = {}
        for spec, a, b in zip(list(net)[:-1], acts[label][:-1],
                              acts["torch"][:-1]):
            check(a.shape == b.shape, f"plan {label} {spec.name}: shape "
                  f"{tuple(a.shape)}, expected {tuple(b.shape)}")
            rel[spec.name] = ((a - b).abs().max() / b.abs().max()).item()
        # log-probabilities: the logits less their row's logsumexp; the
        # clamp keeps probabilities that underflow out of the comparison
        logp_diff = max(
            (torch.log(a.clamp_min(1e-30)) - torch.log(b.clamp_min(1e-30)))
            .abs().max().item() for a, b in zip(probs[label], probs["torch"]))
        prob_diff = max((a - b).abs().max().item()
                        for a, b in zip(probs[label], probs["torch"]))
        prob_ok = all(torch.allclose(a, b, rtol=PROB_RTOL, atol=PROB_ATOL)
                      for a, b in zip(probs[label], probs["torch"]))
        worst = max(rel, key=rel.get)
        print(f"[main] plan={label} vs torch: layer_rel_err="
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
    return totals, by_plan


def lm_kernel_cases(torch, F, ref, kern, rng):
    """(kernel, label, main_path, flops, bytes, kernel_fn, plain_fn,
    library_fn) for the attention kernels at qwen2-1.5B's head shapes in
    bf16; main_path marks the shapes the prefill and serve phases give
    them.  Operations and bytes count what these inputs need: the keys each
    query attends (causal, and for paged only positions <= pos), each input
    read once and the output written once."""
    hq, hk, d = 12, 2, 128

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().bfloat16()

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    cases = []

    def paged_case(label, pos_list, max_seq, main):
        b, nb = len(pos_list), -(-max_seq // PAGE)
        tb = b * nb + 1                                 # + the trash page
        q, ka, va = t(b, hq, 1, d), t(tb, hk, PAGE, d), t(tb, hk, PAGE, d)
        ids = rng.permutation(tb - 1)
        bt = ids[:b * nb].reshape(b, nb).astype(np.int32)
        bt[-1] = 0                      # an inactive slot: every entry page 0
        pos = np.asarray(pos_list, np.int32)
        bt_d, pos_d = torch.from_numpy(bt).cuda(), torch.from_numpy(pos).cuda()
        keys = int((pos + 1).sum())
        pages = int((pos // PAGE + 1).sum())
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
            "paged_attention", label, main, 4 * hq * d * keys, n_bytes,
            lambda: kern["paged_attention"](q, ka, va, bt_d, pos_d),
            lambda: ref.paged_attention_ref(q, ka, va, bt_d, pos_d,
                                            max_seq=max_seq),
            library))

    def flash_case(label, b, s, main):
        q, k, v = t(b, hq, s, d), t(b, hk, s, d), t(b, hk, s, d)
        kr, vr = (x.repeat_interleave(hq // hk, dim=1) for x in (k, v))
        cases.append((
            "flash_attention", label, main, 4 * b * hq * d * s * (s + 1) // 2,
            2 * nbytes(q) + nbytes(k, v),
            lambda: kern["flash_attention"](q, k, v, causal=True),
            lambda: ref.attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                   is_causal=True)))

    # the serve phase's decode shape: 8 slots over 160 positions, one on a
    # page's last position, one on the next page's first, one inactive
    serve_seq = PROMPT + GEN
    paged_case("serve-8x160", [0, 15, 16, 47, 90, 128, 159, 0], serve_seq,
               True)
    paged_case("8x2048", [0, 15, 16, 300, 1023, 1500, 2047, 0], 2048, False)
    flash_case("prefill-1x512", 1, PREFILL_TOKENS, True)
    for b, s in ((4, 512), (1, 2048), (4, 2048)):
        flash_case(f"{b}x{s}", b, s, False)
    return cases


def phase_lm_kernels(torch, F, ref, kern):
    """Each attention kernel against its plain version; returns the main
    path's per-call numbers by kernel, max_abs_err over every shape."""
    rng = np.random.default_rng(1)
    main_case, worst, failed = {}, {}, []
    for (name, label, main, flops, n_bytes, fn, plain,
         library) in lm_kernel_cases(torch, F, ref, kern, rng):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) \
            and torch.allclose(got.float(), want.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
        ms, plain_ms, lib_ms = (time_ms(torch, f)
                                for f in (fn, plain, library))
        bound_ms, bound_by = bound(flops, n_bytes, "bfloat16")
        print(f"[lm-kernels] {name:<15} {label:<13} bf16 "
              f"out={tuple(got.shape)} max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
              flush=True)
        if not ok:
            failed.append(f"{name} {label}: max_abs_err {err:.3e}")
        if min(ms, plain_ms, lib_ms) < bound_ms:
            failed.append(f"{name} {label}: a time below the bound "
                          f"{bound_ms:.4f} ms: the bound counts too much")
        worst[name] = max(worst.get(name, 0.0), err)
        if main:
            main_case[name] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by}
    check(not failed, "attention kernel checks failed: " + "; ".join(failed))
    for name, case in main_case.items():
        case["max_abs_err"] = worst[name]
    return main_case


def device_profile(torch, fn, label: str) -> None:
    """Where the time goes in one call of ``fn``: torch.profiler's device
    kernel times summed by kind, against the host-clock wall time of the
    same call (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = (("paged_attention", ("paged_attention_kernel",)),
             ("flash_attention", ("flash_attention_kernel",)),
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


def phase_prefill(torch, kern, cfg, params):
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
                       "prefill")
    plain_rel = _rel(dot, want)
    rel = _rel(logits, want)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[prefill] qwen2-1.5b 1x{PREFILL_TOKENS} hopper ms={ms:.3f} "
          f"chunked_ms={plain_ms:.3f} logits={tuple(logits.shape)} "
          f"max_rel_err={rel:.3e} (dot vs chunked: {plain_rel:.3e}) "
          f"argmax_agreement={agree:.4f} "
          f"launches={launches}", flush=True)
    check(logits.shape == (1, PREFILL_TOKENS, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite")
    check(len(cache["layers"]) == cfg.n_layers, "prefill cache layers")
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"prefill launches {launches}, expected flash_attention x "
          f"{cfg.n_layers} and nothing else")
    check(rel <= PREFILL_RTOL, f"prefill logits differ from the chunked "
          f"impl by {rel:.3e} of their largest magnitude")
    return launches


def phase_serve(torch, kern, cfg, params):
    """EngineLoop.run on the paged kernel, one decode step held against
    the ref impl, and the same requests served on the ref impl."""
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

    def serve(c, reqs):
        loop = EngineLoop(c, params, n_slots=SLOTS, max_seq=max_seq,
                          block_size=PAGE)
        torch.cuda.synchronize()
        metrics = loop.run(reqs)
        torch.cuda.synchronize()
        return metrics.summary()

    # first-call costs: a short request through each impl
    for c in (hopper, ref_cfg):
        serve(c, synthetic_workload(1, rate=1e9, vocab=cfg.vocab,
                                    prompt_lens=(4,), gen_lens=(2,), seed=9))
    for fn in kern.values():
        fn.launches = 0
    reqs = workload()
    summary = serve(hopper, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    steps = summary["steps"]
    print(f"[serve] qwen2-1.5b hopper requests_done="
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
    ref_summary = serve(ref_cfg, ref_reqs)
    agree = np.mean([np.mean(np.asarray(a.output) == np.asarray(b.output))
                     for a, b in zip(reqs, ref_reqs)])
    print(f"[serve] qwen2-1.5b ref tok/s={ref_summary['tok_per_s']:.1f} "
          f"ttft_p50_s={ref_summary['ttft_p50_s']:.4f} elapsed_s="
          f"{ref_summary['elapsed_s']:.3f}; greedy tokens equal to the "
          f"hopper run: {agree:.4f} (reported, not gated)", flush=True)

    # one decode step, kernel against plain, from a live mid-decode state
    pool = KVPool(SLOTS, max_seq, block_size=PAGE)
    eng = SlotEngine(hopper, params, pool)
    for r in workload()[:SLOTS - 1]:       # the last slot stays inactive
        r.slot = pool.alloc(r.rid, r.total_tokens)
        eng.bind(r, steps_total=r.prompt_len + r.max_new_tokens - 1)
    mid = PROMPT + GEN // 4                # a quarter into decoding
    eng.dispatch(mid, eng.active)
    tokens = torch.randint(0, cfg.vocab, (SLOTS, 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    active = torch.tensor(eng.active, device="cuda")
    outs = []
    with torch.no_grad():
        for c in (hopper, ref_cfg):
            cache = {"layers": [{k: a.clone() for k, a in layer.items()}
                                for layer in eng.cache["layers"]],
                     "pos": eng.cache["pos"].clone(),
                     "block_tables": eng.cache["block_tables"].clone()}
            outs.append(T.decode_step_slots_paged(
                eng.params, c, cache, tokens, active, max_seq=max_seq)[0])
        left = int((eng.steps_total - eng.steps_done)[eng.active].min())
        device_profile(torch, lambda: eng.dispatch(min(8, left), eng.active),
                       "serve")
    live = active.nonzero().flatten()
    rel = _rel(outs[0][live], outs[1][live])
    print(f"[serve] one decode step at pos {mid}: hopper vs ref "
          f"max_rel_err={rel:.3e}", flush=True)
    check(rel <= DECODE_RTOL, f"decode-step logits differ from the ref impl "
          f"by {rel:.3e} of their largest magnitude")
    return launches, summary, ref_summary


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

    # 4. the main path
    launches, by_plan = phase_main(torch, kern, net, layer_ms)

    # 5. the attention kernels against their plain versions
    lm = phase_lm_kernels(torch, F, ref, kern)

    # 6-7. qwen2-1.5B at full width: prefill, then serving
    t0 = time.perf_counter()
    params = T.compute_params(T.init_params(QWEN2, seed=0), QWEN2)
    torch.cuda.synchronize()
    print(f"[qwen2] {T.count_params(QWEN2):,} parameters from seed 0, "
          f"bf16 copy in {time.perf_counter() - t0:.1f} s", flush=True)
    prefill_launches = phase_prefill(torch, kern, QWEN2, params)
    serve_launches, _, _ = phase_serve(torch, kern, QWEN2, params)
    by_phase = {"alexnet": launches, "prefill": prefill_launches,
                "serve": serve_launches}
    home = {"flash_attention": "prefill", "paged_attention": "serve"}

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
                   ("ms", "plain_ms", "bound_ms", "library_ms")},
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
                library_ms=agg["library_ms"])
        rows.append(row)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
