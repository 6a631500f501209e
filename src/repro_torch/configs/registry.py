"""Architecture & shape registry, the port's copy of the JAX package's.

Each ported architecture contributes a module of this package defining:
  CONFIG        — the exact published configuration (ModelConfig)
  SMOKE         — a reduced same-family config for CPU smoke tests
  LR_SCHEDULE   — the schedule the arch trains with

Shapes are the assignment's four workloads.  ``supports()`` encodes the
skip rules (long_500k needs sub-quadratic attention).

Only ``qwen2_1_5b`` and ``alexnet`` are ported.  ``get`` raises
``NotImplementedError`` for every other name in ``ARCH_NAMES`` (ROADMAP §1
item 7), and so does ``all_archs`` until they are.  ``input_specs`` and
``runnable_cells`` wait for the dry run (item 9).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from ..models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str               # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_NAMES = [
    "deepseek_coder_33b",
    "minicpm_2b",
    "qwen2_1_5b",
    "granite_34b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
    "mixtral_8x7b",
    "phi35_moe",
    "falcon_mamba_7b",
    "llama32_vision_90b",
    "alexnet",             # the paper's own network (CNN path)
]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    config: Optional[ModelConfig]        # None for the CNN (AlexNet) path
    smoke: Optional[ModelConfig]
    lr_schedule: str = "cosine"
    family: str = "lm"                   # lm | cnn


def get(name: str) -> ArchSpec:
    name = name.replace("-", "_").replace(".", "")
    module = f"{__package__}.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as err:
        if err.name != module or name not in ARCH_NAMES:
            raise
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP §1 item 7: the other "
            "architectures); the port has qwen2_1_5b and alexnet") from None
    return ArchSpec(
        name=name,
        config=getattr(mod, "CONFIG", None),
        smoke=getattr(mod, "SMOKE", None),
        lr_schedule=getattr(mod, "LR_SCHEDULE", "cosine"),
        family=getattr(mod, "FAMILY", "lm"),
    )


def all_archs() -> Dict[str, ArchSpec]:
    return {n: get(n) for n in ARCH_NAMES}


def _is_subquadratic(cfg: ModelConfig) -> bool:
    types = set(cfg.layer_types())
    has_full_attn = ("attn" in types or "xattn" in types) \
        and cfg.attn_window is None
    return not has_full_attn


def supports(arch: ArchSpec, shape_name: str) -> Tuple[bool, str]:
    if arch.family == "cnn":
        return False, "CNN arch: LM shapes not applicable (paper network)"
    if shape_name == "long_500k" and not _is_subquadratic(arch.config):
        return False, ("pure full-attention arch: O(L^2) attention at "
                       "L=524288 is not servable — skipped per assignment")
    return True, ""
