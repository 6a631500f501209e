"""Learning-rate schedules, the JAX package's: constant, cosine with linear
warmup, and WSD (Warmup-Stable-Decay), the schedule minicpm
(arXiv:2404.06395) trains with.  Each maps a step (an int or a tensor) to
an fp32 scalar tensor on the step's device, in the JAX package's fp32
arithmetic."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_step(step), lr)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def f(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay (minicpm): linear warmup, long flat stage, then a
    fast exponential-style decay to final_frac*peak over decay_steps."""
    def f(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        d0 = warmup_steps + stable_steps
        prog = torch.clamp((step - d0) / max(decay_steps, 1), 0.0, 1.0)
        log_final = torch.log(torch.tensor(final_frac, dtype=torch.float32,
                                           device=step.device))
        decay = peak_lr * torch.exp(log_final * prog)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < d0, torch.full_like(
                               step, peak_lr), decay))
    return f
