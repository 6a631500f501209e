"""Fault-tolerance runtime pieces, the JAX package's.

* StepTimer — EWMA step-time tracker with straggler detection: a step that
  exceeds mean + k·σ (or m× the EWMA) is flagged, and the launcher logs it.
  On a card it synchronizes before reading the clock at each end of a
  step, so a step's time is the device's work and not its enqueue.

* PreemptionHandler — SIGTERM/SIGINT → "checkpoint then exit" flag.  The
  train loop polls ``should_stop`` each step and saves a final checkpoint
  before exiting, so a preempted worker loses at most one step.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import List, Optional

import torch


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration_s: float
    ewma_s: float
    threshold_s: float

    def __str__(self) -> str:
        return (f"[straggler] step {self.step}: {self.duration_s:.3f}s "
                f"(ewma {self.ewma_s:.3f}s, "
                f"threshold {self.threshold_s:.3f}s)")


class StepTimer:
    """``device``: the device the steps run on; a CUDA device is
    synchronized before each clock read."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 3.0,
                 min_steps: int = 5, ratio: float = 2.0, *, device="cpu"):
        self.alpha = alpha
        self.k_sigma = k_sigma
        self.min_steps = min_steps
        self.ratio = ratio
        self.device = torch.device(device)
        self.ewma: Optional[float] = None
        self.ewvar: float = 0.0
        self.n = 0
        self.stragglers: List[StragglerReport] = []
        self._t0: Optional[float] = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic()

    def start(self) -> None:
        self._t0 = self._now()

    def stop(self, step: int) -> Optional[StragglerReport]:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = self._now() - self._t0
        self._t0 = None
        report = None
        if self.ewma is None:
            self.ewma = dt
        else:
            # flag if EITHER criterion trips: ratio-based always (after
            # warmup), sigma-based once variance statistics exist
            thresh = self.ratio * self.ewma
            if self.ewvar > 0:
                thresh = min(thresh,
                             self.ewma + self.k_sigma * (self.ewvar ** 0.5))
            if self.n >= self.min_steps and dt > thresh:
                report = StragglerReport(step, dt, self.ewma, thresh)
                self.stragglers.append(report)
            delta = dt - self.ewma
            self.ewma += self.alpha * delta
            self.ewvar = (1 - self.alpha) * (self.ewvar
                                             + self.alpha * delta * delta)
        self.n += 1
        return report


class PreemptionHandler:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop."""

    def __init__(self, install: bool = True):
        self._stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:      # not the main thread
                    pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def request_stop(self) -> None:    # for tests / manual drain
        self._stop = True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
