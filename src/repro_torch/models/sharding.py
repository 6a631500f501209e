"""Logical-axis sharding rules -> partition specs and DTensor placements,
with divisibility fallbacks (the JAX package's ``models/sharding.py`` on
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``).

The production mesh is (data=16, model=16) per pod, with an outer 'pod' axis
across pods.  Policy:

* **TP mode** (head count divides the 'model' axis): heads/d_ff/experts
  shard over 'model'; batch over ('pod','data'); params FSDP over 'data'
  on their d_model/vocab dimension (ZeRO-style).
* **FSDP/SP mode** (heads don't divide — deepseek 56H, minicpm 36H, qwen2
  12H, recurrentgemma 10H): activations shard *sequence* over 'model',
  params shard over both 'data' and 'model' purely for storage (ZeRO-3).

Every rule is a *priority list* of mesh axes; the resolver takes the first
candidate whose size divides the dimension and that isn't already used by
another dimension of the same array (e.g. mixtral's 8 kv-heads on a 16-way
axis fall back to replicated kv, phi3.5's 16 experts take 'model').

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis name
or a tuple of axis names (equal to ``tuple()`` of the JAX package's
``PartitionSpec``).  On a ``DeviceMesh`` :meth:`ShardingPolicy.named` also
gives the DTensor placements, one per mesh dim: a dim sharded over
``("pod", "data")`` is ``Shard(i)`` on both mesh dims, which DTensor splits
in mesh order (major to minor, JAX's order).  :func:`place` puts a tree on
its shardings: ``distribute_tensor`` on a multi-rank mesh, a plain tensor on
the device of a one-device mesh (there every spec is replicated).

The names follow the port's parameter layout: one dict per layer in
``layers`` (and ``encoder``), no leading stacked-layers axis.  The caches
covered are :func:`~repro_torch.models.transformer.init_cache`'s dense
layout, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..tree import tree_map

from .transformer import ModelConfig, encoder_config, map_params, param_shapes

Tree = Any
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis -> ordered candidate mesh-axis tuples ((..) may fuse axes)
RULES: Dict[str, Sequence[Tuple[str, ...]]] = {
    "batch":      [("pod", "data"), ("data",), ("pod",), ()],
    "seq":        [("model",), ()],          # only consulted in fsdp/sp mode
    "heads":      [("model",), ()],
    "kv_heads":   [("model",), ()],
    "ff":         [("model",), ()],
    "expert":     [("model",), ()],
    "d_inner":    [("model",), ()],
    "vocab":      [("model",), ()],
    "embed":      [("data",), ()],            # param FSDP dim
    "embed2":     [("model",), ()],            # ZeRO-3 second storage dim
    "cache_time": [("model",), ()],
    "cache_batch": [("data",), ("pod",), ()],
    "replicated": [()],
}

# resolution priority: most contended axes first
_PRIORITY = ["expert", "heads", "kv_heads", "ff", "d_inner", "vocab", "seq",
             "cache_time", "batch", "cache_batch", "embed", "embed2",
             "replicated"]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s named dims, or a mocked mesh's
    ``shape`` mapping (unit tests)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process's leaves live on: the device a host mesh was
    made for (``launch.mesh.make_host_mesh`` records it), else the current
    device of the mesh's type, where DTensor puts a rank's shard."""
    device = getattr(mesh, "host_device", None)
    if device is not None:
        return device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's place on a ``DeviceMesh``: its spec and the DTensor
    placements it gives, one per mesh dim."""
    mesh: DeviceMesh
    spec: Spec
    placements: Tuple[Placement, ...]


def spec_placements(dim_names: Sequence[str],
                    spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on a mesh with dims ``dim_names``:
    ``Shard(i)`` on every mesh dim that tensor dim i is sharded over,
    ``Replicate()`` on the others."""
    out = [Replicate()] * len(dim_names)
    for i, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            out[dim_names.index(axis)] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    tp_mode: bool          # True -> TP; False -> FSDP/SP fallback
    zero3: bool = False    # shard params over 'model' too (fsdp mode)
    # SSM archs: the recurrence is sequential in S, so sequence sharding
    # would serialize across shards — instead shard batch over the WHOLE
    # mesh (pure DP + ZeRO storage)
    pure_dp: bool = False

    def resolve(self, shape: Tuple[int, ...],
                names: Sequence[Optional[str]]) -> Spec:
        assert len(shape) == len(names), (shape, names)
        axes = mesh_axes(self.mesh)
        chosen: Dict[int, Tuple[str, ...]] = {}
        used: set = set()
        order = sorted(range(len(names)),
                       key=lambda i: _PRIORITY.index(names[i])
                       if names[i] in _PRIORITY else 99)
        for i in order:
            ln = names[i]
            if ln is None or ln not in RULES:
                continue
            if ln == "embed2" and not self.zero3:
                continue
            rules = RULES[ln]
            if self.pure_dp:
                if ln == "seq":
                    continue
                if ln == "batch":
                    rules = [("pod", "data", "model"), ("data", "model"),
                             ("pod", "data"), ("data",), ()]
            for cand in rules:
                if not cand:
                    break                                   # explicit no-shard
                if any(a not in axes for a in cand):
                    continue                                # axis not in mesh
                if any(a in used for a in cand):
                    continue                                # axis taken
                size = 1
                for a in cand:
                    size *= axes[a]
                if size > 1 and shape[i] % size == 0:
                    chosen[i] = cand
                    used.update(cand)
                    break
        parts = []
        for i in range(len(shape)):
            c = chosen.get(i, ())
            parts.append(c[0] if len(c) == 1 else (c if c else None))
        return tuple(parts)

    def named(self, shape: Tuple[int, ...],
              names: Sequence[Optional[str]]) -> Union[Spec, Sharding]:
        spec = self.resolve(shape, names)
        if not isinstance(self.mesh, DeviceMesh):   # mocked mesh (unit tests)
            return spec
        return Sharding(self.mesh, spec,
                        spec_placements(self.mesh.mesh_dim_names, spec))


def make_policy(cfg: ModelConfig, mesh) -> ShardingPolicy:
    model = mesh_axes(mesh).get("model", 1)
    tp = cfg.n_heads == 0 or cfg.n_heads % model == 0
    pure_dp = any(t in ("mamba", "rec") for t in cfg.layer_types())
    return ShardingPolicy(mesh=mesh, tp_mode=tp, zero3=not tp,
                          pure_dp=pure_dp)


# ---------------------------------------------------------------------------
# Logical names for every param in the transformer tree
# ---------------------------------------------------------------------------
def _attn_names(cfg: ModelConfig, cross: bool = False) -> Dict:
    n = {
        "wq": ["embed", "heads"],
        "wk": ["embed", "kv_heads"],
        "wv": ["embed", "kv_heads"],
        "wo": ["heads", "embed"],
    }
    if cfg.qkv_bias and not cross:      # a cross projection has no bias
        n["bq"] = ["heads"]
        n["bk"] = ["kv_heads"]
        n["bv"] = ["kv_heads"]
    return n


def _mlp_names(cfg: ModelConfig) -> Dict:
    if cfg.n_experts > 0:
        return {
            "router": ["embed", "replicated"],
            "w_gate": ["expert", "embed", "ff"],
            "w_up": ["expert", "embed", "ff"],
            "w_down": ["expert", "ff", "embed"],
        }
    n = {
        "w_up": ["embed", "ff"],
        "w_down": ["ff", "embed"],
    }
    if cfg.gated_mlp:
        n["w_gate"] = ["embed", "ff"]
    return n


def _block_names(btype: str, cfg: ModelConfig, with_cross: bool) -> Dict:
    vec = ["replicated"]
    if btype == "attn":
        n = {"ln1": vec, "attn": _attn_names(cfg), "ln2": vec,
             "mlp": _mlp_names(cfg)}
        if with_cross:
            n["lnx"] = vec
            n["xattn"] = _attn_names(cfg, cross=True)
        return n
    if btype == "xattn":
        return {"ln1": vec, "xattn": _attn_names(cfg, cross=True),
                "ln2": vec, "mlp": _mlp_names(cfg),
                "gate_attn": [], "gate_mlp": []}
    if btype == "rec":
        return {"ln1": vec,
                "rec": {
                    "x_proj": ["embed", "d_inner"],
                    "gate_proj": ["embed", "d_inner"],
                    "conv_w": ["replicated", "d_inner"],
                    "conv_b": ["d_inner"],
                    "w_a": ["embed2", "d_inner"],
                    "b_a": ["d_inner"],
                    "w_i": ["embed2", "d_inner"],
                    "b_i": ["d_inner"],
                    "lambda": ["d_inner"],
                    "out_proj": ["d_inner", "embed"],
                },
                "ln2": vec, "mlp": _mlp_names(cfg)}
    if btype == "mamba":
        return {"ln1": vec,
                "mamba": {
                    "in_proj": ["embed", "d_inner"],
                    "conv_w": ["replicated", "d_inner"],
                    "conv_b": ["d_inner"],
                    "x_proj": ["d_inner", "replicated"],
                    "dt_proj": ["replicated", "d_inner"],
                    "dt_bias": ["d_inner"],
                    "A_log": ["d_inner", "replicated"],
                    "D": ["d_inner"],
                    "out_proj": ["d_inner", "embed"],
                }}
    raise ValueError(btype)


def param_logical_names(cfg: ModelConfig) -> Dict:
    """Logical axis names of every leaf of the port's parameter tree
    (``transformer.param_shapes``' layout)."""
    names: Dict[str, Any] = {
        "embed": ["vocab", "embed"],
        "final_norm": ["replicated"],
        "layers": [_block_names(t, cfg, cfg.encoder_decoder)
                   for t in cfg.layer_types()],
    }
    if not cfg.tie_embeddings:
        names["lm_head"] = ["embed", "vocab"]
    if cfg.encoder_decoder:
        enc = encoder_config(cfg)
        names["encoder"] = [_block_names(t, enc, False)
                            for t in enc.layer_types()]
        names["enc_final_norm"] = ["replicated"]
    return names


def _tree_shardings(shapes: Tree, names: Tree, policy: ShardingPolicy,
                    path: str = "params") -> Tree:
    if isinstance(shapes, Mapping):
        if set(shapes) != set(names):
            raise ValueError(f"{path}: keys {sorted(shapes)}, names for "
                             f"{sorted(names)}")
        return {k: _tree_shardings(v, names[k], policy, f"{path}.{k}")
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        if len(shapes) != len(names):
            raise ValueError(f"{path}: {len(shapes)} layers, names for "
                             f"{len(names)}")
        return [_tree_shardings(s, n, policy, f"{path}[{i}]")
                for i, (s, n) in enumerate(zip(shapes, names))]
    shape = tuple(shapes.shape)
    # pad/truncate to rank (scalars, ())
    return policy.named(shape,
                        (list(names) + [None] * len(shape))[:len(shape)])


def param_shardings(cfg: ModelConfig, policy: ShardingPolicy,
                    params: Tree) -> Tree:
    """The sharding of every leaf of a parameter tree (real or ``meta``
    tensors), in the tree's layout."""
    return _tree_shardings(params, param_logical_names(cfg), policy)


def batch_shardings(cfg: ModelConfig, policy: ShardingPolicy,
                    batch_shapes: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape)
        if k in ("tokens", "labels", "mask"):
            out[k] = policy.named(shape, ["batch", "seq"])
        elif k in ("enc_inputs", "img_embeds"):
            out[k] = policy.named(shape, ["batch", "seq", None])
        else:
            out[k] = policy.named(shape, [None] * len(shape))
    return out


def cache_shardings(cfg: ModelConfig, policy: ShardingPolicy,
                    cache_shapes: Tree) -> Tree:
    """Caches: kv (B, HK, T, D) — kv_heads over 'model' when divisible,
    else time over 'model'; batch over 'data'.  SSM states: d_inner over
    'model'.  Dispatches on the leaf's nearest dict key in the cache tree."""
    def leaf(key: str, x):
        shape = tuple(x.shape)
        rank = len(shape)
        if key in ("k", "v") and rank >= 4:
            lead = [None] * (rank - 4)
            return policy.named(shape, lead + ["cache_batch", "kv_heads",
                                               "cache_time", None])
        if key == "h" and rank >= 3 and shape[-1] == cfg.ssm_state:
            lead = [None] * (rank - 3)
            return policy.named(shape, lead + ["cache_batch", "d_inner", None])
        if key == "h" and rank >= 2:                       # rglru (B, DI)
            lead = [None] * (rank - 2)
            return policy.named(shape, lead + ["cache_batch", "d_inner"])
        if key == "conv" and rank >= 3:                    # (B, K-1, DI)
            lead = [None] * (rank - 3)
            return policy.named(shape, lead + ["cache_batch", None, "d_inner"])
        if key == "cross" and rank == 3:                   # (B, T, D)
            return policy.named(shape, ["cache_batch", "seq", None])
        return policy.named(shape, [None] * rank)

    def walk(tree, key: str):
        if isinstance(tree, Mapping):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return leaf(key, tree)

    return walk(cache_shapes, "")


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def meta_params(cfg: ModelConfig) -> Tree:
    """The parameter tree as tensors on the ``meta`` device: the shapes and
    the dtype ``init_params`` gives, nothing allocated."""
    return map_params(lambda _, shape: torch.empty(
        shape, dtype=cfg.param_dtype, device="meta"), param_shapes(cfg))


def place(tree: Tree, shardings: Tree) -> Tree:
    """Each tensor of ``tree`` on its :class:`Sharding` (same structure:
    dicts, lists, tuples and named tuples): ``distribute_tensor`` on a mesh
    of more than one rank (a DTensor already there is kept, one elsewhere
    redistributed); on a one-device mesh, where every spec is replicated,
    the plain tensor on the mesh's device (the tensor itself when it is
    there already)."""
    def put(t, s):
        if not isinstance(s, Sharding):
            raise TypeError(f"place needs a DeviceMesh's shardings, got "
                            f"{s!r}")
        if s.mesh.size() == 1:
            return t.to(mesh_device(s.mesh))
        if isinstance(t, DTensor):
            if t.device_mesh == s.mesh and tuple(t.placements) == tuple(
                    s.placements):
                return t
            return t.redistribute(s.mesh, s.placements)
        return distribute_tensor(t, s.mesh, list(s.placements))

    return tree_map(put, tree, shardings)
