"""Fault-tolerant checkpointing in the JAX package's on-disk format.

* every leaf of the state tree is written as its own .npy file named by its
  path (``tree.tree_paths``: dict keys, sequence indices and named-tuple
  fields as ``.field``, joined by "/", the file name joining them by
  "__"), so a checkpoint of either package names its leaves alike;
* ``manifest.json`` records the step, each leaf's name, file, dtype and
  shape, and ``extra`` (the data pipeline's cursor);
* writes go to ``step_XXXXXXXX.tmp`` and are renamed into place: a
  half-written checkpoint is never visible;
* keep-last-k garbage collection.

numpy has no bfloat16: a bfloat16 leaf is written as its raw 16 bits
(uint16) with dtype ``"bfloat16"`` in the manifest, and read back as
bfloat16.  Restore loads every leaf onto one given device, or each onto
its template leaf's device; restoring onto another mesh (resharding) comes
with the trainer across devices (ROADMAP §1 item 9b).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map_with_path, tree_paths

Tree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, state: Tree,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically write ``state`` (a tree of tensors or arrays) at
    ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in tree_paths(state):
        name = "/".join(path)
        arr, dtype = _to_numpy(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        (int(m.group(1)), d) for d in os.listdir(directory)
        if (m := _STEP_RE.match(d)))
    for _, d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _load(path: str, meta: Dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        # the port's uint16 bits, or a JAX-side ml_dtypes array (read by
        # numpy as 2-byte voids)
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_latest(directory: str, template: Tree, *, device=None
                   ) -> Optional[Tuple[int, Tree, Dict]]:
    """Restore the newest checkpoint into the structure of ``template``:
    (step, state, extra), or None if there is none.  Each leaf is read in
    its saved dtype onto ``device``, or onto its template leaf's device
    when ``device`` is None."""
    step = latest_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    def load(p, leaf):
        name = "/".join(p)
        if name not in by_name:
            raise KeyError(f"checkpoint {path} has no leaf {name!r}")
        where = device if device is not None else getattr(
            leaf, "device", "cpu")
        return _load(path, by_name[name]).to(where)

    return step, tree_map_with_path(load, template), manifest.get("extra",
                                                                  {})


class CheckpointManager:
    """Convenience wrapper used by the train loop."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep

    def maybe_save(self, step: int, state: Tree,
                   extra: Optional[Dict] = None, force: bool = False):
        if force or (self.interval > 0 and step % self.interval == 0
                     and step > 0):
            return save_checkpoint(self.directory, step, state, extra,
                                   self.keep)
        return None

    def restore(self, template: Tree, *, device=None):
        return restore_latest(self.directory, template, device=device)
