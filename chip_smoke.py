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

The last line is {"ok": true, "device": {...}}; the line before it holds the
card's name and power limit, and the one before that the per-kernel JSON,
whose times are summed over the layers a kernel runs in one forward of the
kernel plan at batch 64 and whose launches are those of phase 4 (in all, and
per plan under "launches_by_plan").
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
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:46",
    "conv2d": "src/repro/kernels/conv2d.py:50",
    "pool": "src/repro/kernels/pooling.py:33",
    "lrn": "src/repro/kernels/lrn.py:36",
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
                         "t_ops": 0.0, "t_bytes": 0.0} for name in kern}
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
        for fn in kern.values():       # count the main path's launches only
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
        check(all(totals.values()), f"a kernel never ran on the main path: "
              f"{totals}")
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
    from repro_torch.kernels.conv2d import SOURCE as CONV_SRC, conv2d_cuda
    from repro_torch.kernels.lrn import SOURCE as LRN_SRC, lrn_cuda
    from repro_torch.kernels.matmul import SOURCE as MATMUL_SRC, matmul_cuda
    from repro_torch.kernels.pooling import SOURCE as POOL_SRC, pool_cuda
    kern = {"matmul": matmul_cuda, "conv2d": conv2d_cuda, "pool": pool_cuda,
            "lrn": lrn_cuda}
    sources = {"matmul": MATMUL_SRC, "conv2d": CONV_SRC, "pool": POOL_SRC,
               "lrn": LRN_SRC}

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

    rows = []
    for name in kern:
        agg = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_plan": {plan: n[name] for plan, n in by_plan.items()},
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": ("operations" if agg["t_ops"] > agg["t_bytes"]
                         else "bytes"),
            "library_ms": agg["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
