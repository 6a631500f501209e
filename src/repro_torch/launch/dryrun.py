"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on
DTensor under a fake process group, and count what each device would do.

For each cell the dry run:
  1. opens a fake default process group of 256 (single pod, 16x16) or 512
     (multi-pod, 2x16x16) ranks (``launch.mesh.fake_process_group``) and
     builds the production mesh over it on the CPU;
  2. builds the step and its shardings (``launch.steps.build_step``);
  3. places the abstract arguments, ``meta`` tensors, on their shardings as
     DTensors and runs the step on them through ``steps.sharded``, the
     counterpart of ``jax.jit(fn, in_shardings=, out_shardings=)``: nothing
     is allocated and no card is needed.  A cell passes when every op of
     the step gets through DTensor's sharding propagation (the counterpart
     of "compile succeeded");
  4. records what :class:`StepCounter` counted into a JSON file that
     ``launch.roofline`` turns into the three-term roofline table.

What the counter measures in place of XLA's analyses (the JAX package
reads ``memory_analysis()``, ``cost_analysis()`` and the collectives of
the optimized HLO):

* **FLOPs per device**: ``torch.utils.flop_counter``'s formula on each
  DTensor op's global shapes, over the product of the sizes of the mesh
  dims on which its output is ``Shard`` or ``Partial`` (a ``Replicate``
  dim repeats the work on every device).  Plain-tensor ops (a one-device
  mesh) count whole.
* **Bytes per device**: the local bytes of the inputs and the outputs of
  every op that is not a view.  These are unfused bytes: an upper bound on
  what a fused step moves.
* **Collectives**: the result bytes of each functional collective DTensor
  issues, on its local tensor (an all-gather's gathered tensor, an
  all-reduce's full tensor, a reduce-scatter's shard), under the JAX
  package's five names.  What is recorded is what DTensor issued: on the
  fake group an all-to-all may come as an all-gather and a local chunk.
* **Memory**: argument bytes are the placed arguments' local bytes,
  alias bytes the donated ones', output bytes the outputs' after they are
  redistributed to their shardings, temp bytes the peak of the live local
  bytes the step created (outputs included while the step runs).  XLA's
  code bytes have no counterpart.

DTensor's own choice of layouts is kept, with one change: where a strided
shard is involved it prices the candidates cheaply (see
``_quick_strided_costs``), since its exact price takes minutes per op on
the multipod mesh.

The step runs eagerly, so every layer is counted: the JAX package's L0/L1
calibration (HloCostAnalysis counts a while body once) becomes a check,
L0 + (n_layers / unit) x (L1 - L0) = the full count (``--calibrate``).

Run on the CPU from the repository root::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1_5b \\
        --shape decode_32k --mesh pod --set n_layers=1

Nothing is set in the environment at import.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import traceback
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import registry
from ..obs.trace import default_clock
from ..tree import tree_leaves
from .mesh import fake_process_group, make_production_mesh, production_ranks
from .steps import build_step, sharded

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collectives (``torch.ops._c10d_functional``) by the JAX
# package's names
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL = "_c10d_functional"
DEFAULT_OUT = os.path.join("build", "dryrun_results.json")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of one device's part of ``t``."""
    t = _local(t)
    return t.numel() * t.element_size()


def _shards(t: DTensor) -> int:
    """Devices the work of an op with output ``t`` is split over."""
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if not isinstance(p, Replicate):        # Shard, _StridedShard, Partial
            n *= size
    return n


class StepCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes, collectives and live bytes of the
    ops run under it (see the module docstring).  ``external``: tensors
    (the step's arguments) whose storage the step did not create."""

    def __init__(self, external: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in _COLLECTIVES}
        self.collective_count = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}     # key -> [bytes, refs]
        self._external = {self._key(_local(t)) for t in external}
        self._keep = list(external)              # keep the keys unique
        self._in_dtensor = False

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until the last tensor
        seen on it is freed."""
        key = self._key(t)
        if key in self._external:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            first = outs[0] if outs else None
            self.flops += n / (_shards(first) if isinstance(first, DTensor)
                               else 1)
        if not (func.is_view or packet is torch.ops.aten._unsafe_view):
            self.bytes += sum(local_bytes(t)
                              for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(_local(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func.namespace == _FUNCOL:
            out = func(*args, **kwargs)
            name = _COLLECTIVE_OF.get(func._overloadpacket.__name__)
            if name is not None:
                self.collectives[name] += sum(local_bytes(t)
                                              for t in _tensors(out))
                self.collective_count += 1
                for t in _tensors(out):
                    self._track(t)
            return out
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                # DTensor runs the op with this mode still on the stack, so
                # the collectives of its redistributions reach the branch
                # above
                return NotImplemented
            self._in_dtensor = True
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._in_dtensor = False
            self._count(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        if not self._in_dtensor:        # DTensor's own local work is
            self._count(func, args, kwargs, out)   # counted at its op
        return out


def _strided(spec) -> bool:
    return any(type(p).__name__ == "_StridedShard" for p in spec.placements)


@contextlib.contextmanager
def _quick_strided_costs() -> Iterator[None]:
    """Price DTensor's candidate layouts cheaply where a strided shard is
    involved (the layout a view leaves when it flattens a batch split with
    another split dim, as every product over heads does): DTensor prices
    each candidate of an op by a shortest-path search over the placements
    of every mesh dim, minutes per op on the multipod mesh.  Such a pair
    is priced here at the bytes of one shard per mesh dim whose placement
    changes.  Only the choice among candidates reads this price; the
    chosen redistributions run, and are counted, as DTensor plans them."""
    try:
        from torch.distributed.tensor import _collective_utils, _ops
        utils = _ops.utils
        exact = utils.redistribute_cost
    except (ImportError, AttributeError):      # another torch: leave it
        yield
        return

    def cost(current, target):
        if not (_strided(current) or _strided(target)):
            return exact(current, target)
        moved = sum(a != b for a, b in zip(current.placements,
                                           target.placements))
        return moved * _collective_utils.spec_to_bytes(current) / max(
            current.num_shards, 1) / 2**30

    utils.redistribute_cost = cost
    try:
        yield
    finally:
        utils.redistribute_cost = exact


def count_step(fn: Callable, in_shardings, out_shardings,
               donate: Sequence[int], placed_args: Sequence[Any]) -> Dict:
    """Run ``fn`` once on the placed arguments, through
    :func:`~repro_torch.launch.steps.sharded`'s output redistribution,
    under a :class:`StepCounter`: the record's counts (FLOPs, bytes,
    collectives, memory)."""
    args_t = _tensors(placed_args)
    counter = StepCounter(external=args_t)
    step = sharded(fn, in_shardings, out_shardings)
    with _quick_strided_costs(), counter:
        out = step(*placed_args)
    return {
        "flops_per_device": counter.flops,
        "bytes_per_device": counter.bytes,
        "collective_bytes_per_device": sum(counter.collectives.values()),
        "collectives": dict(counter.collectives),
        "collective_count": counter.collective_count,
        "memory": {
            "argument_bytes": sum(local_bytes(t) for t in args_t),
            "output_bytes": sum(local_bytes(t) for t in _tensors(out)),
            "temp_bytes": counter.peak,
            "alias_bytes": sum(local_bytes(t) for i in donate
                               for t in _tensors(placed_args[i])),
        },
    }


def _mesh_name(multi_pod: bool) -> str:
    return "multipod" if multi_pod else "pod"


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             extra_cfg: Optional[dict] = None,
             now_fn: Callable[[], float] = default_clock) -> Dict:
    """Trace one cell on its production mesh under a fake process group;
    returns the roofline record (``trace_s``: building, placing and running
    the step, on ``now_fn``'s monotonic clock)."""
    arch = registry.get(arch_name)
    if extra_cfg:
        arch = dataclasses.replace(
            arch, config=dataclasses.replace(arch.config, **extra_cfg))
    ok, reason = registry.supports(arch, shape_name)
    if not ok:
        return {"arch": arch_name, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "status": "skipped",
                "reason": reason}
    from ..models.sharding import place

    with fake_process_group(production_ranks(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = now_fn()
        fn, in_sh, out_sh, donate, args = build_step(arch, shape_name, mesh)
        placed = tuple(place(a, s) for a, s in zip(args, in_sh))
        counts = count_step(fn, in_sh, out_sh, donate, placed)
        trace_s = now_fn() - t0
        n_chips = mesh.size()
    record = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "status": "ok",
        "n_chips": int(n_chips),
        "mode": registry.SHAPES[shape_name].mode,
        "trace_s": round(trace_s, 1),
    }
    record.update(counts)
    return record


def calibration_overrides(arch: "registry.ArchSpec", shape_name: str):
    """Two config variants at depth 0 and at one pattern unit (dot
    attention, single-chunk scans), the JAX package's calibration pair:
    ``launch.roofline`` reconstructs full-depth counts as
        corrected = L0 + (n_layers / unit_len) * (L1 - L0).
    The port counts every layer of an eager step, so here the pair checks
    the count's linearity in depth rather than correcting it."""
    cfg = arch.config
    shape = registry.SHAPES[shape_name]
    unit = len(cfg.pattern_unit())
    base = {"attention_impl": "dot"}
    if shape.mode != "decode":
        base["scan_chunk"] = shape.seq_len         # single-chunk SSM scans
    l0 = dict(base, n_layers=0)
    l1 = dict(base, n_layers=unit)
    if cfg.encoder_decoder:
        l0["enc_layers"] = 0
        l1["enc_layers"] = 1
    return l0, l1


def run_calibration(arch_name: str, shape_name: str) -> Dict:
    """The L0 and L1 records of one cell on the pod mesh."""
    arch = registry.get(arch_name)
    ok, reason = registry.supports(arch, shape_name)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": "pod",
                "status": "skipped", "calibration": True, "reason": reason}
    l0, l1 = calibration_overrides(arch, shape_name)
    rec0 = run_cell(arch_name, shape_name, False, extra_cfg=l0)
    rec1 = run_cell(arch_name, shape_name, False, extra_cfg=l1)
    out = {"arch": arch_name, "shape": shape_name, "mesh": "pod",
           "status": "ok", "calibration": True,
           "unit_len": len(arch.config.pattern_unit()),
           "n_layers": arch.config.n_layers}
    for tag, rec in (("L0", rec0), ("L1", rec1)):
        for k in ("flops_per_device", "bytes_per_device",
                  "collective_bytes_per_device"):
            out[f"{tag}_{k}"] = rec[k]
    return out


def _load(path: str) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def _save(path: str, results: list) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def _error_record(arch_name, shape_name, mesh, exc) -> Dict:
    return {"arch": arch_name, "shape": shape_name, "mesh": mesh,
            "status": "error", "error": f"{type(exc).__name__}: {exc}",
            "trace": traceback.format_exc()[-2000:]}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.dryrun",
        description="multi-pod dry run on DTensor under a fake process group")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod",
                                                       "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf iterations)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the L0/L1 calibration cells (pod mesh)")
    args = ap.parse_args(argv)

    extra = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        extra[k] = v

    archs = ([a for a in registry.ARCH_NAMES if a != "alexnet"]
             if args.arch == "all" else [args.arch])
    shapes = list(registry.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "multipod"]

    results = _load(args.out)
    if args.calibrate:
        done = {(r["arch"], r["shape"]) for r in results
                if r.get("calibration") and r.get("status") in ("ok",
                                                                "skipped")}
        for arch_name in archs:
            for shape_name in shapes:
                if (arch_name, shape_name) in done:
                    print(f"[skip cached cal] {(arch_name, shape_name)}")
                    continue
                print(f"[calibrate] {(arch_name, shape_name)} ...",
                      flush=True)
                try:
                    rec = run_calibration(arch_name, shape_name)
                except Exception as e:  # a failure here is a bug; record it
                    rec = dict(_error_record(arch_name, shape_name, "pod", e),
                               calibration=True)
                results.append(rec)
                _save(args.out, results)
                print(f"[{rec['status']}] cal {(arch_name, shape_name)}",
                      flush=True)
        return

    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok" and not r.get("calibration")
            and not extra}
    for arch_name in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                key = (arch_name, shape_name, _mesh_name(multi_pod))
                if key in done:
                    print(f"[skip cached] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = run_cell(arch_name, shape_name, multi_pod,
                                   extra_cfg=extra or None)
                except Exception as e:  # a failure here is a bug; record it
                    rec = _error_record(arch_name, shape_name, key[2], e)
                if extra:
                    rec["overrides"] = extra
                results = [r for r in results if r.get("calibration")
                           or (r["arch"], r["shape"], r["mesh"]) != key
                           or r.get("overrides") != rec.get("overrides")]
                results.append(rec)
                _save(args.out, results)
                msg = rec.get("error", "")
                if rec["status"] == "ok":
                    coll = rec["collective_bytes_per_device"] / 1e6
                    msg = (f"trace {rec['trace_s']}s, "
                           f"{rec['flops_per_device'] / 1e9:.1f} GFLOP/dev, "
                           f"coll {coll:.1f} MB/dev")
                print(f"[{rec['status']}] {key} {msg}", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run complete: {n_ok} ok, {n_err} errors -> {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
