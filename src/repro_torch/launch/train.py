"""Training CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \
        --steps 200 --batch 8 --seq 128 --scale smoke --ckpt-dir /tmp/ckpt

The JAX package's ``repro.launch.train`` flags, schedule choice and log
lines (``step … loss … lr … gnorm``, ``[restore] resumed at step N``,
``done: …``), plus ``--device`` (default ``cuda``: it trains on the card
unless ``--device cpu`` is given, and raises without one).  Wired in:

  * fp32 master weights from ``init_params(cfg, seed=0)``, the compute
    dtype where each weight is used, AdamW (decay set of the JAX package)
    on the arch's schedule (WSD or cosine) peaking at ``--lr``;
  * checkpoint/restore with atomic publish and keep-k (``--ckpt-dir``,
    ``--ckpt-interval``), the data pipeline's cursor in the checkpoint;
  * preemption handling (SIGTERM -> checkpoint -> clean exit) and
    straggler detection (EWMA step timer, synchronized on a card);
  * for an encoder-decoder or vision arch, the data pipeline's front-end
    stub embeddings in every batch (frames of ``--seq`` for the encoder,
    the config's ``img_seq`` patches), which the train step passes on;
  * gradient accumulation over ``max(--grad-accum, the config's
    grad_accum)`` microbatches, as the JAX package's step builder takes
    it, and int8 gradient compression with error feedback
    (``--grad-compression int8``).

``--mesh pod`` and ``--mesh multipod`` wait for the sharding work (ROADMAP
§1 item 9) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import registry
from ..data import DataConfig, make_pipeline
from ..models import transformer as T
from ..optim import adamw, compression, schedules
from ..runtime import PreemptionHandler, StepTimer
from .steps import make_train_step


def _schedule(name: str, steps: int, peak_lr: float = 3e-3):
    if name == "wsd":
        return schedules.wsd_schedule(peak_lr, max(steps // 20, 1),
                                      int(steps * 0.7), int(steps * 0.25))
    return schedules.cosine_schedule(peak_lr, max(steps // 20, 1), steps)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="the schedule's peak learning rate")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--corpus", default="")
    ap.add_argument("--mesh", default="host", choices=["host", "pod",
                                                       "multipod"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: not ported yet; ROADMAP §1 item 9 "
            "(sharding) ports it")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")

    arch = registry.get(args.arch)
    cfg = arch.smoke if args.scale == "smoke" else arch.config
    if cfg is None:
        raise ValueError(f"{args.arch} has no LM config")
    if args.seq % max(cfg.scan_chunk, 1):
        cfg = dataclasses.replace(cfg, scan_chunk=min(cfg.scan_chunk,
                                                      args.seq))

    # ---- data -------------------------------------------------------
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab=cfg.vocab, frontend=cfg.frontend,
                      d_model=cfg.d_model, img_seq=cfg.img_seq,
                      enc_len=args.seq)
    pipe = make_pipeline(dcfg, corpus=args.corpus or None, device=device)

    # ---- state ------------------------------------------------------
    init_opt, update = adamw.make_optimizer(
        _schedule(arch.lr_schedule, args.steps, args.lr),
        decay=T.decay_mask(cfg))
    params = T.init_params(cfg, seed=0, device=device)
    opt_state = init_opt(params)
    err_fb = (compression.init_error(params)
              if args.grad_compression == "int8" else None)

    # ---- restore ----------------------------------------------------
    start_step = 0
    ckpt = (CheckpointManager(args.ckpt_dir, args.ckpt_interval)
            if args.ckpt_dir else None)
    if ckpt:
        restored = ckpt.restore({"params": params, "opt": opt_state},
                                device=device)
        if restored:
            start_step, state, extra = restored
            params, opt_state = state["params"], state["opt"]
            if "data" in extra:
                pipe.restore(extra["data"])
            print(f"[restore] resumed at step {start_step}")

    # ---- loop -------------------------------------------------------
    train_step = make_train_step(cfg, update, grad_accum=args.grad_accum)
    timer = StepTimer(device=device)
    preempt = PreemptionHandler()
    t_start = time.time()
    step = start_step
    try:
        for step in range(start_step, args.steps):
            batch = next(pipe)
            timer.start()
            params, opt_state, err_fb, metrics = train_step(
                params, opt_state, err_fb, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            straggler = timer.stop(step)
            if straggler:
                print(straggler)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} "
                      f"gnorm {metrics['grad_norm']:.3f}", flush=True)
            if ckpt:
                ckpt.maybe_save(step, {"params": params, "opt": opt_state},
                                extra={"data": pipe.state()})
            if preempt.should_stop:
                print("[preempt] saving final checkpoint and exiting")
                if ckpt:
                    ckpt.maybe_save(step, {"params": params,
                                           "opt": opt_state},
                                    extra={"data": pipe.state()},
                                    force=True)
                break
    finally:
        preempt.uninstall()

    if ckpt and not preempt.should_stop:
        ckpt.maybe_save(step, {"params": params, "opt": opt_state},
                        extra={"data": pipe.state()}, force=True)
    dt = time.time() - t_start
    n = max(step - start_step + 1, 1)
    print(f"done: {n} steps in {dt:.1f}s ({dt / n * 1e3:.0f} ms/step); "
          f"stragglers flagged: {len(timer.stragglers)}")


if __name__ == "__main__":
    main()
