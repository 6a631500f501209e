"""Device topology: mesh construction and phase device assignment.

Functions (not module-level constants) so importing this module touches no
device and no process group.  Two concerns live here:

* **Meshes** for params/cache sharding (``models.sharding``), as
  ``torch.distributed`` ``DeviceMesh`` objects with the JAX package's axis
  names.  Single pod: 16x16 = 256 ranks, axes (data, model).  Multi-pod:
  2 pods = 512 ranks, axes (pod, data, model); 'pod' is the outer
  data-parallel axis.  The production meshes span the default process
  group (one rank per card, launched with ``torchrun``, or the ranks of
  :func:`fake_process_group`, which allocates nothing and communicates
  nothing: the dry run's stand-in for a pod); the host mesh is 1x1 over
  one device and needs no process group.  Serve and train place their
  weights on the host mesh, and ``launch.steps.build_step`` runs on either;
  serving and training on the production meshes are ROADMAP §1 item 9b.
* **Phase device assignment** for disaggregated serving
  (:class:`DeviceAssignment`): with at least two visible devices the
  prefill and decode engines go to distinct ones, otherwise both share the
  one there is (the JAX package's policy, and what one H100 gives).
  Devices are ``torch.device`` objects of one type, ``cuda`` (every
  visible card) or ``cpu`` (one device).

Not here, unlike the JAX package's ``launch/mesh.py``:
``forced_host_device_env`` sets an XLA flag that splits a CPU host into
logical devices.  PyTorch has no counterpart: its CPU is one device, so the
two-device hand-off runs only where two cards are visible (a fake process
group stands in for a pod's ranks in tests).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# quoted when an index is out of range, so the error says how to see more
# devices
MULTI_DEVICE_HINT = ("a distinct decode device needs a second card: "
                     "CUDA_VISIBLE_DEVICES selects which are visible")


POD_SHAPE, MULTIPOD_SHAPE = (16, 16), (2, 16, 16)


def production_ranks(multi_pod: bool = False) -> int:
    """Ranks of the pod mesh (256) or the multipod mesh (512)."""
    return math.prod(MULTIPOD_SHAPE if multi_pod else POD_SHAPE)


def _register_fake_backend() -> None:
    """Register c10d's ``fake`` backend once (``torch.testing``'s fake
    process group registers the same creator; either registration
    serves)."""
    if "FAKE" in dist.Backend._plugins:
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", FakeProcessGroup)
        return make(common_opts.group_rank, common_opts.group_size,
                    backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """The default process group as rank 0 of ``world_size`` fake ranks:
    every collective returns at once with its output's shape and moves no
    data, so a production mesh of meta tensors can be traced in one
    process.  Refuses to replace a default group that already exists, and
    destroys its own on exit, pass or fail."""
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a default process group "
                           "already exists")
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The pod mesh (data=16, model=16), or with ``multi_pod`` the
    (pod=2, data=16, model=16) mesh, over the default process group (real
    ranks, or :func:`fake_process_group`'s with ``device_type="cpu"``)."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks but the process group has "
            f"{have}: launch {need} processes, one per device (e.g. "
            f"torchrun --nnodes N --nproc-per-node 8 with N * 8 = {need}), "
            f"each calling torch.distributed.init_process_group first")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """Degenerate 1x1 mesh over one device, axes (data, model), built with
    no process group (a plain process serves or trains on it).  The device
    is recorded on the mesh as ``host_device`` (``sharding.mesh_device``
    reads it)."""
    device = torch.device(device)
    mesh = DeviceMesh(device.type, torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    mesh.host_device = device
    return mesh


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
