"""Persistent profile cache: measured layer timings keyed by environment.

CNNLab's middleware knows its accelerators because it *measured* them; the
cache is where those measurements live between runs.  Each entry is one
:class:`~repro_torch.profiling.bench.Measurement` keyed by

    (layer-spec fingerprint, engine, torch version, device name, capability)

so a measurement taken on another card, or under another torch, never
prices a plan here: a :class:`ProfileCache` is a view for one device, its
lookups only return entries whose environment matches that device's, and
:meth:`ProfileCache.invalidate_stale` drops the rest.

On-disk format (``schema`` guards future layout changes)::

    {"schema": 1, "entries": {"<key>": {<measurement dict>}, ...}}

``python -m repro_torch.profiling.cache --validate PATH`` checks a cache
file against the schema and requires entries usable on ``--device``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

import torch

from ..core.layer_model import LayerSpec

SCHEMA_VERSION = 1

# the environment fields a measurement is valid under
ENV_FIELDS = ("torch_version", "device_name", "capability")
# measurement dict fields every entry must carry (mirrors bench.Measurement)
REQUIRED_FIELDS = (
    "layer", "kind", "engine", "batch", "dtype", "repeats",
    "t_median", "t_iqr", "t_min", "t_mean", "flops", "fingerprint",
) + ENV_FIELDS

DEFAULT_CACHE_PATH = os.environ.get("REPRO_TORCH_PROFILE_CACHE",
                                    "build/profile_cache_torch.json")


def environment(device="cuda") -> Dict[str, str]:
    """The (torch version, device name, compute capability) a measurement
    on ``device`` is valid under.  A CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cpu":
        return {"torch_version": torch.__version__, "device_name": "cpu",
                "capability": "none"}
    if device.type != "cuda":
        raise ValueError(f"no profiling environment for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("profiling: no CUDA device is available; pass "
                           "device='cpu' to measure on the CPU")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    major, minor = torch.cuda.get_device_capability(index)
    return {"torch_version": torch.__version__,
            "device_name": torch.cuda.get_device_name(index),
            "capability": f"{major}.{minor}"}


def fingerprint(spec: LayerSpec, batch: int, dtype: str) -> str:
    """Stable digest of a layer spec + measurement shape.

    Hashes the spec's declarative tuple (type + all dataclass fields), the
    batch and the dtype — everything that determines the timed computation.
    """
    payload = json.dumps(
        {"type": type(spec).__name__,
         "fields": {f.name: repr(getattr(spec, f.name))
                    for f in dataclasses.fields(spec)},
         "batch": int(batch), "dtype": str(dtype)},
        sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def entry_key(fp: str, engine: str, env: Dict[str, str]) -> str:
    return "|".join((fp, engine) + tuple(env[f] for f in ENV_FIELDS))


def _env_of(m: dict) -> Dict[str, str]:
    return {f: m[f] for f in ENV_FIELDS}


def validate_dict(data) -> List[str]:
    """Schema check for a loaded cache dict.  Returns a list of problems
    (empty == valid)."""
    errors: List[str] = []
    if not isinstance(data, dict):
        return [f"cache root must be an object, got {type(data).__name__}"]
    if data.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema must be {SCHEMA_VERSION}, "
                      f"got {data.get('schema')!r}")
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return errors + ["entries must be an object"]
    for key, m in entries.items():
        if not isinstance(m, dict):
            errors.append(f"{key}: entry must be an object")
            continue
        missing = [f for f in REQUIRED_FIELDS if f not in m]
        if missing:
            errors.append(f"{key}: missing fields {missing}")
            continue
        want = entry_key(m["fingerprint"], m["engine"], _env_of(m))
        if key != want:
            errors.append(f"{key}: key does not match entry ({want})")
        for f in ("t_median", "t_iqr", "t_min", "t_mean"):
            if not (isinstance(m[f], (int, float)) and m[f] >= 0):
                errors.append(f"{key}: {f} must be a non-negative number")
    return errors


class ProfileCache:
    """In-memory view of the persistent cache; lookups are scoped to the
    environment of ``device`` (read when first needed)."""

    def __init__(self, path: Optional[str] = None, *, device="cuda"):
        self.path = path
        self.device = torch.device(device)
        self.entries: Dict[str, dict] = {}
        self._env: Optional[Dict[str, str]] = None

    @property
    def env(self) -> Dict[str, str]:
        if self._env is None:
            self._env = environment(self.device)
        return self._env

    # ---- persistence -----------------------------------------------------
    @classmethod
    def load(cls, path: str, *, strict: bool = True,
             device="cuda") -> "ProfileCache":
        """Read a cache file.  Missing file -> empty cache (profiling always
        has a cold-start path); malformed file raises when ``strict``."""
        cache = cls(path, device=device)
        if not os.path.exists(path):
            return cache
        with open(path) as f:
            data = json.load(f)
        errors = validate_dict(data)
        if errors:
            if strict:
                raise ValueError(f"invalid profile cache {path}: {errors}")
            return cache
        cache.entries = dict(data["entries"])
        return cache

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or DEFAULT_CACHE_PATH
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "entries": self.entries},
                      f, indent=2, sort_keys=True)
        return path

    # ---- lookups (this device's environment only) ------------------------
    def get(self, spec: LayerSpec, engine: str, *, batch: int = 1,
            dtype: str = "float32") -> Optional[dict]:
        return self.entries.get(
            entry_key(fingerprint(spec, batch, dtype), engine, self.env))

    def put(self, measurement) -> None:
        m = (measurement.to_dict() if hasattr(measurement, "to_dict")
             else dict(measurement))
        self.entries[entry_key(m["fingerprint"], m["engine"],
                               _env_of(m))] = m

    def measurements(self, *, engine: Optional[str] = None,
                     source: Optional[str] = None,
                     stale: bool = False) -> List[dict]:
        """Entries for this device's environment (all when ``stale``),
        optionally only those of one ``engine`` or provenance ``source``."""
        out = []
        for m in self.entries.values():
            if engine is not None and m["engine"] != engine:
                continue
            if source is not None and m.get("source") != source:
                continue
            if not stale and _env_of(m) != self.env:
                continue
            out.append(m)
        return out

    # ---- maintenance -----------------------------------------------------
    def merge(self, other: "ProfileCache") -> int:
        """Fold another cache in (other wins on key collision).  Returns the
        number of new/updated entries."""
        changed = 0
        for key, m in other.entries.items():
            if self.entries.get(key) != m:
                self.entries[key] = dict(m)
                changed += 1
        return changed

    def invalidate(self, *, engine: Optional[str] = None) -> int:
        """Drop entries (optionally only one engine's).  Returns count."""
        keep = {k: m for k, m in self.entries.items()
                if engine is not None and m["engine"] != engine}
        dropped = len(self.entries) - len(keep)
        self.entries = keep
        return dropped

    def invalidate_stale(self) -> int:
        """Drop entries measured on another card or under another torch."""
        keep = {k: m for k, m in self.entries.items()
                if _env_of(m) == self.env}
        dropped = len(self.entries) - len(keep)
        self.entries = keep
        return dropped

    def __len__(self) -> int:
        return len(self.entries)


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="profile-cache maintenance (schema validation)")
    ap.add_argument("--validate", metavar="PATH", required=True,
                    help="check PATH against the cache JSON schema and "
                         "require usable entries for --device")
    ap.add_argument("--allow-empty", action="store_true",
                    help="accept a schema-valid cache with no entries "
                         "usable on --device")
    ap.add_argument("--device", default="cuda",
                    help="the device whose environment entries must match")
    args = ap.parse_args()
    if not os.path.exists(args.validate):
        raise SystemExit(f"[cache] INVALID: {args.validate}: no such file "
                         f"(run `python -m repro_torch.launch.profile` "
                         f"first)")
    with open(args.validate) as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as e:
            raise SystemExit(f"[cache] INVALID: {args.validate}: "
                             f"not JSON ({e})")
    errors = validate_dict(data)
    if errors:
        for e in errors:
            print(f"[cache] INVALID: {e}")
        raise SystemExit(1)
    # a schema-valid cache that no lookup can use is a failure too: lookups
    # only see entries measured on this card under this torch
    n = len(data["entries"])
    env = environment(args.device)
    usable = sum(1 for m in data["entries"].values() if _env_of(m) == env)
    if usable == 0 and not args.allow_empty:
        raise SystemExit(
            f"[cache] INVALID: {args.validate}: schema OK but no usable "
            f"entries for torch {env['torch_version']} on "
            f"{env['device_name']} ({env['capability']}) ({n} total; "
            f"measured-pricing lookups would find nothing — re-profile "
            f"here, or pass --allow-empty to accept)")
    print(f"[cache] {args.validate}: schema v{data['schema']} OK, "
          f"{n} entr{'y' if n == 1 else 'ies'} ({usable} usable in this "
          f"environment)")


if __name__ == "__main__":
    _main()
