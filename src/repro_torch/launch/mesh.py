"""Device topology: phase device assignment for disaggregated serving.

:class:`DeviceAssignment` pins the prefill and decode engines to devices:
with at least two visible devices they go to distinct ones, otherwise both
share the one there is (the JAX package's policy, and what one H100 gives).
Devices are ``torch.device`` objects of one type, ``cuda`` (every visible
card) or ``cpu`` (one device).

Not here, unlike the JAX package's ``launch/mesh.py``:

* ``make_production_mesh`` and ``make_host_mesh`` (params and cache
  sharding over a pod) come with the sharding work (ROADMAP §1 item 9);
* ``forced_host_device_env`` sets an XLA flag that splits a CPU host into
  logical devices.  PyTorch has no counterpart: its CPU is one device, so
  the two-device hand-off runs only where two cards are visible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

# quoted when an index is out of range, so the error says how to see more
# devices
MULTI_DEVICE_HINT = ("a distinct decode device needs a second card: "
                     "CUDA_VISIBLE_DEVICES selects which are visible")


@dataclasses.dataclass(frozen=True)
class DeviceAssignment:
    """Which device each serving phase's engine lives on.

    ``distinct`` is the bit the hand-off path branches on: when False both
    engines share one device and the hand-off is a same-device copy, when
    True it crosses a device boundary and the asynchronous hand-off has
    real latency to hide.
    """
    prefill: torch.device
    decode: torch.device

    @property
    def distinct(self) -> bool:
        return self.prefill != self.decode

    def summary(self) -> str:
        tag = "distinct" if self.distinct else "shared"
        return (f"prefill -> {device_label(self.prefill)}, "
                f"decode -> {device_label(self.decode)} ({tag})")


def device_label(dev) -> str:
    """Stable human/cache-readable name for one device, e.g. ``cuda:1``."""
    dev = torch.device(dev)
    return f"{dev.type}:{0 if dev.index is None else dev.index}"


def visible_devices(backend: str = "cuda") -> List[torch.device]:
    """The devices a phase engine may be pinned to: every visible card for
    ``backend="cuda"``, the one CPU device for ``"cpu"``."""
    if backend == "cpu":
        return [torch.device("cpu")]
    if backend != "cuda":
        raise ValueError(f"unknown device backend {backend!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_assignment(*, prefill_index: Optional[int] = None,
                      decode_index: Optional[int] = None,
                      backend: str = "cuda") -> DeviceAssignment:
    """Pin the two serving phases to devices.

    Default policy: with >= 2 visible devices, prefill takes device 0 and
    decode device 1; with one device both phases share it (the code path is
    the same, the hand-off a same-device copy).  Explicit ``prefill_index``
    / ``decode_index`` override the policy; an out-of-range index raises
    rather than silently colocating.
    """
    devs = visible_devices(backend)
    if not devs:
        raise RuntimeError(f"no {backend} devices visible")

    def pick(idx: Optional[int], default: int, phase: str) -> torch.device:
        if idx is None:
            idx = default if default < len(devs) else 0
        if not 0 <= idx < len(devs):
            raise ValueError(
                f"{phase} device index {idx} out of range: only "
                f"{len(devs)} {backend} device(s) visible "
                f"({MULTI_DEVICE_HINT})")
        return devs[idx]

    return DeviceAssignment(prefill=pick(prefill_index, 0, "prefill"),
                            decode=pick(decode_index, 1, "decode"))
