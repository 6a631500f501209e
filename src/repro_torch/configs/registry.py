"""Architecture & shape registry, the port's copy of the JAX package's.

Each ported architecture contributes a module of this package defining:
  CONFIG        — the exact published configuration (ModelConfig)
  SMOKE         — a reduced same-family config for CPU smoke tests
  LR_SCHEDULE   — the schedule the arch trains with

Shapes are the assignment's four workloads.  ``supports()`` encodes the
skip rules (long_500k needs sub-quadratic attention).

Every architecture is ported: the decoder-only ones, the encoder-decoder
``seamless_m4t_medium``, the vision decoder ``llama32_vision_90b`` and
``alexnet``.  ``runnable_cells`` lists the (arch, shape) cells and
``input_specs`` gives each cell's abstract inputs as tensors on the
``meta`` device (nothing allocated), the JAX package's ``ShapeDtypeStruct``
stand-ins, which ``launch.steps.build_step`` and the dry run
(``launch.dryrun``) take.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from ..models.transformer import ModelConfig, init_cache


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
    mod = importlib.import_module(f"{__package__}.{name}")
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


def runnable_cells():
    """All (arch, shape) pairs that must pass the dry-run."""
    cells = []
    for name in ARCH_NAMES:
        arch = get(name)
        if arch.family == "cnn":
            continue
        for shape_name in SHAPES:
            ok, _ = supports(arch, shape_name)
            if ok:
                cells.append((name, shape_name))
    return cells


# ---------------------------------------------------------------------------
# Abstract input specs (meta tensors — no allocation)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """Returns the abstract inputs for the step function of this cell.

    train:   {"batch": {tokens, labels[, enc_inputs | img_embeds]}}
    prefill: {"tokens": (B,S)[, enc_inputs | img_embeds]}
    decode:  {"tokens": (B,1), "cache": <meta cache, init_cache's layout>}
    """
    cfg = arch.config
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    tok = lambda seq: _meta((b, seq), torch.int32)

    def frontend(seq):
        ex = {}
        if cfg.encoder_decoder:
            ex["enc_inputs"] = _meta((b, seq, cfg.d_model), torch.bfloat16)
        elif cfg.frontend == "vision":
            ex["img_embeds"] = _meta((b, cfg.img_seq, cfg.d_model),
                                     torch.bfloat16)
        return ex

    if shape.mode == "train":
        batch = {"tokens": tok(s), "labels": tok(s)}
        batch.update(frontend(s))
        return {"batch": batch}
    if shape.mode == "prefill":
        out = {"tokens": tok(s)}
        out.update(frontend(s))
        return out
    # decode: abstract cache of length s
    return {"tokens": tok(1),
            "cache": init_cache(cfg, b, max_seq=s, device="meta")}
