"""The built steps on DTensors that hold values, on a real 4-rank group.

Four CPU processes form a gloo group and a (2, 2) ('data', 'model')
``DeviceMesh``.  For SMOKE qwen2 (3 query heads and 1 key/value head,
chunked attention over 8-key chunks, two microbatches), mixtral,
falcon-mamba and seamless (one encoder layer, a vocab of 511 that no mesh
dim divides), cut to one layer, in float32, each rank runs
``build_step``'s train, prefill and decode steps through ``sharded``; the
outputs, gathered whole, are held to the same steps on the host mesh, run
in this process on the same weights and inputs: float32 leaves within
2e-4, the bfloat16 conv states also within one bfloat16 step
(``tests/test_torch_families.py``'s rule), integers exactly.

This drives on values the model's branches that only a DTensor takes (the
heads gathered where the 'model' axis does not divide them, the queries'
sequence split, the weights gathered over the batch axes, the head and
the loss over a split vocab and over a whole one, forward and backward,
the masked row write of a sharded cache, the replaced recurrent states,
the MoE buffer's hint, the microbatches of a sharded batch); the dry run
drives them on ``meta`` tensors only.  The ranks price DTensor's strided
candidates as the dry run does (``dryrun._quick_strided_costs``), so the
layouts held here are the ones whose costs the dry run counts.
"""
import dataclasses
import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry as pregistry
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps as psteps
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

ARCHS = {
    # 3 query heads and 1 key/value head, which the 2-wide 'model' axis
    # does not divide
    "qwen2_1_5b": dict(attention_impl="chunked", attn_chunk=8, grad_accum=2,
                       n_heads=3, n_kv_heads=1),
    "mixtral_8x7b": {},
    "falcon_mamba_7b": {},
    # an odd vocab that no mesh dim splits: the head's product keeps the
    # sequence split, and the loss splits the sequence in its place
    "seamless_m4t_medium": dict(enc_layers=1, vocab=511),
}
MODES = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
CASES = [(a, m) for a in ARCHS for m in MODES]
B, S = 4, 16
TOL = 2e-4
CONV_RTOL = 2.0 ** -7
WORLD = 4


def _arch(name):
    arch = pregistry.get(name)
    cfg = dataclasses.replace(arch.smoke, n_layers=1,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32, **ARCHS[name])
    return dataclasses.replace(arch, config=cfg)


def _args(arch, mode, rng):
    """The step's arguments, plain CPU tensors drawn from ``rng``."""
    cfg = arch.config
    params = PT.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S),
                                           dtype=np.int32))
    extras = {}
    if cfg.encoder_decoder:
        extras["enc_inputs"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    if mode == "train":
        opt = adamw.adamw_init(params)
        opt = opt._replace(step=torch.tensor(100, dtype=torch.int32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S),
                                               dtype=np.int32))
        return (params, opt, dict(tokens=tokens, labels=labels, **extras))
    if mode == "prefill":
        return (params, tokens) + tuple(extras.values())
    cache = PT.init_cache(cfg, B, max_seq=S, device="cpu")

    def fill(t):
        if not t.is_floating_point():
            return t
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
            np.float32)).to(t.dtype)

    cache = dict(tree_map(fill, cache), pos=torch.tensor(5, dtype=torch.int32))
    return (params, cache, tokens[:, :1])


def _copy(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _worst(got, want):
    """(number of leaves, largest float32 error, the leaves out of
    tolerance)."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    worst, bad = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if not isinstance(w, torch.Tensor):
            continue
        g = g.reshape(w.shape)
        if g.dtype != w.dtype:
            bad.append((i, f"dtype {g.dtype} != {w.dtype}"))
        elif not w.is_floating_point():
            if not torch.equal(g, w):
                bad.append((i, "integers differ"))
        else:
            err = (g.float() - w.float()).abs()
            rtol = CONV_RTOL if w.dtype == torch.bfloat16 else 0.0
            if bool((err > TOL + rtol * w.float().abs()).any()):
                bad.append((i, f"{w.dtype} error {float(err.max()):.3e}"))
            if w.dtype == torch.float32:
                worst = max(worst, float(err.max()))
    return len(want), worst, bad


def _worker(rank, store, case_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    results = {}
    try:
        mesh = dist.device_mesh.init_device_mesh(
            "cpu", (2, 2), mesh_dim_names=("data", "model"))
        cases = torch.load(case_path, weights_only=False)
        for key, (args, want) in cases.items():
            arch_name, mode = key
            try:
                fn, in_sh, out_sh, _, _ = psteps.build_step(
                    _arch(arch_name), MODES[mode], mesh)
                with dryrun._quick_strided_costs():
                    out = psteps.sharded(fn, in_sh, out_sh)(*args)
                placed = sum(hasattr(t, "full_tensor")
                             for t in tree_leaves(out))
                results[key] = (placed,) + _worst(tree_map(_whole, out), want)
            except Exception:                  # every rank fails alike
                results[key] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(results, out_path)


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """Each case's (DTensor outputs, leaves, largest float32 error, leaves
    out of tolerance) from the 4-rank run, or its traceback."""
    tmp = tmp_path_factory.mktemp("steps_dist")
    rng = np.random.default_rng(11)
    host = pmesh.make_host_mesh("cpu")
    cases = {}
    for arch_name, mode in CASES:
        arch = _arch(arch_name)
        args = _args(arch, mode, rng)
        fn, in_sh, out_sh, _, _ = psteps.build_step(arch, MODES[mode], host)
        want = psteps.sharded(fn, in_sh, out_sh)(*_copy(args))
        cases[(arch_name, mode)] = (args, want)
    case_path, out_path = tmp / "cases.pt", tmp / "results.pt"
    torch.save(cases, case_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "store"), str(case_path),
                               str(out_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD
    assert not dist.is_initialized()
    assert os.path.exists(out_path)
    return torch.load(out_path, weights_only=False)


@pytest.mark.parametrize("arch,mode", CASES)
def test_sharded_step_equals_the_host_mesh_step(dist_results, arch, mode):
    result = dist_results[(arch, mode)]
    assert not isinstance(result, str), result
    placed, n, worst, bad = result
    assert placed > 0                     # the outputs were DTensors
    assert n > 0 and not bad, (worst, bad)
    assert worst <= TOL
