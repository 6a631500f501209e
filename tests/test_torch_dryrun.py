"""The port's dry run and roofline against the JAX package's, on the CPU.

* The counter on a hand-built case under a fake 256-rank group: x (256,
  1024, 2048) bf16 split over 'data', @ w split over 'model' by columns,
  relu, @ w2 split over 'model' by rows, redistributed to x's placements:
  exactly one all-reduce of one device's (16, 1024, 2048) bf16, and FLOPs
  per device the global 2 x 2 x 256 x 1024 x 2048 x 8192 over 256.
* ``run_cell`` at one pattern unit of depth gives ``ok`` on the pod and the
  multipod mesh for one cell of every mode of every family; in qwen2's
  train cell the loss keeps the logits split (its peak of live bytes is
  well under one 16th of the whole fp32 logits), and a prefill's FLOPs per
  device halve from the pod to the multipod mesh.
* On a one-device mesh the FLOPs per device are ``FlopCounterMode``'s total
  for the same step; argument bytes are the placed leaves' local bytes;
  the calibration identity L0 + 2 (L1 - L0) = L2 holds.
* ``calibration_overrides`` and ``model_flops_per_device`` equal the
  reference's for every cell, and ``roofline_rows`` equals the reference's
  on the same records given a device model with the reference's
  constants.
* The CLI writes its records, resumes, and exits 1 when a cell errs.
* No test leaves a process group behind.
"""
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

import benchmarks.bench_roofline as jroof
from repro.configs import registry as jregistry
from repro_torch.configs import registry as pregistry
from repro_torch.core.device_models import H100, DeviceModel
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.steps import build_step
from repro_torch.models.sharding import place

torch.set_num_threads(2)

CELLS = pregistry.runnable_cells()
# one cell of every mode of every family (dense, MoE, Mamba, RG-LRU,
# encoder-decoder, vision)
UNIT_CELLS = [("qwen2_1_5b", "train_4k"), ("qwen2_1_5b", "prefill_32k"),
              ("qwen2_1_5b", "decode_32k"), ("mixtral_8x7b", "decode_32k"),
              ("falcon_mamba_7b", "long_500k"),
              ("recurrentgemma_2b", "train_4k"),
              ("seamless_m4t_medium", "prefill_32k"),
              ("llama32_vision_90b", "train_4k")]


def _ref_dryrun():
    """The JAX package's dry-run module, imported without keeping the
    512-device XLA flag it sets at import (other tests see one device)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _unit(arch):
    return {"n_layers": len(pregistry.get(arch).config.pattern_unit())}


# ---------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------
def test_counter_on_a_hand_built_case():
    with pmesh.fake_process_group(256):
        mesh = pmesh.make_production_mesh(device_type="cpu")

        def meta(*shape):
            return torch.empty(shape, dtype=torch.bfloat16, device="meta")

        x = distribute_tensor(meta(256, 1024, 2048), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(meta(2048, 8192), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(meta(8192, 2048), mesh,
                               [Replicate(), Shard(0)])
        counter = dryrun.StepCounter(external=[x, w, w2])
        with counter:
            y = torch.relu(x @ w) @ w2
            y = y.redistribute(mesh, [Shard(0), Replicate()])
        assert tuple(y.to_local().shape) == (16, 1024, 2048)
    assert counter.collective_count == 1
    assert counter.collectives == {
        "all-gather": 0.0, "all-reduce": 16 * 1024 * 2048 * 2,
        "reduce-scatter": 0.0, "all-to-all": 0.0, "collective-permute": 0.0}
    assert counter.flops == 2 * 2 * 256 * 1024 * 2048 * 8192 / 256
    # every byte moved is one device's part: the two products' operands
    # and results, relu's input and output, no view
    local = 16 * 1024 * 2048 * 2
    hidden = 16 * 1024 * 512 * 2
    weights = 2048 * 512 * 2
    assert counter.bytes == 2 * (local + weights + hidden) + 2 * hidden
    assert counter.peak >= hidden + local


def test_fake_group_refuses_a_second_group_and_always_cleans_up():
    with pytest.raises(ZeroDivisionError):
        with pmesh.fake_process_group(256):
            assert dist.get_world_size() == 256
            with pytest.raises(RuntimeError, match="already exists"):
                with pmesh.fake_process_group(512):
                    pass
            raise ZeroDivisionError
    assert not dist.is_initialized()


def test_unsupported_cell_is_skipped_with_the_reason():
    rec = dryrun.run_cell("qwen2_1_5b", "long_500k", False)
    ok, reason = pregistry.supports(pregistry.get("qwen2_1_5b"),
                                    "long_500k")
    assert not ok and rec == {"arch": "qwen2_1_5b", "shape": "long_500k",
                              "mesh": "pod", "status": "skipped",
                              "reason": reason}


def test_one_device_flops_equal_flop_counter_mode():
    """On a 1x1 mesh (of ``meta`` tensors) every leaf is a plain tensor:
    the counter's FLOPs are FlopCounterMode's total for the same step."""
    arch = pregistry.get("qwen2_1_5b")
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, n_layers=1))
    mesh = pmesh.make_host_mesh("meta")
    for shape_name in ("train_4k", "decode_32k"):
        fn, in_sh, out_sh, donate, args = build_step(arch, shape_name, mesh)
        counts = dryrun.count_step(fn, in_sh, out_sh, donate, args)
        fn, in_sh, out_sh, donate, args = build_step(arch, shape_name, mesh)
        with FlopCounterMode(display=False) as flop_mode:
            fn(*args)
        assert counts["flops_per_device"] == flop_mode.get_total_flops() > 0
        assert counts["collective_count"] == 0


def test_calibration_identity_at_two_units():
    arch = pregistry.get("qwen2_1_5b")
    l0, l1 = dryrun.calibration_overrides(arch, "prefill_32k")
    l2 = dict(l1, n_layers=2 * l1["n_layers"])
    r0, r1, r2 = (dryrun.run_cell("qwen2_1_5b", "prefill_32k", False,
                                  extra_cfg=o) for o in (l0, l1, l2))
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert r0[k] + 2 * (r1[k] - r0[k]) == r2[k], k


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_calibration_overrides_and_model_flops_equal_the_reference(
        arch, shape_name):
    jdry = _ref_dryrun()
    assert dryrun.calibration_overrides(pregistry.get(arch), shape_name) \
        == jdry.calibration_overrides(jregistry.get(arch), shape_name)
    for n_chips in (256, 512):
        assert roofline.model_flops_per_device(arch, shape_name, n_chips) \
            == jroof.model_flops_per_device(arch, shape_name, n_chips)


def _records():
    """Full-depth, calibration, overridden and error records over a few
    cells, numbers drawn from a seed."""
    import numpy as np
    rng = np.random.default_rng(9)
    out = []
    for i, (arch, shape_name) in enumerate(CELLS[::3]):
        for mesh, n in (("pod", 256), ("multipod", 512)):
            out.append({
                "arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "ok", "n_chips": n,
                "flops_per_device": float(rng.uniform(1e12, 1e16)),
                "bytes_per_device": float(rng.uniform(1e9, 1e13)),
                "collective_bytes_per_device": float(rng.uniform(0, 1e11)),
                "memory": {"argument_bytes": int(rng.integers(1, 1e11)),
                           "temp_bytes": int(rng.integers(0, 1e11))}})
        if i % 2:
            cal = {"arch": arch, "shape": shape_name, "mesh": "pod",
                   "status": "ok", "calibration": True, "unit_len": 2,
                   "n_layers": 30}
            for tag in ("L0", "L1"):
                for k in ("flops_per_device", "bytes_per_device",
                          "collective_bytes_per_device"):
                    cal[f"{tag}_{k}"] = float(rng.uniform(1e9, 1e12))
            out.append(cal)
    out.append(dict(out[0], overrides={"n_layers": 1}))
    out.append({"arch": "qwen2_1_5b", "shape": "train_4k", "mesh": "pod",
                "status": "error", "error": "E"})
    return out


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_roofline_rows_equal_the_reference_on_its_constants(mesh):
    records = _records()
    device = DeviceModel(name="reference", peak_flops=jroof.PEAK_FLOPS,
                         mem_bw=jroof.HBM_BW, link_bw=jroof.LINK_BW)
    got = roofline.roofline_rows(records, mesh, device)
    want = jroof.roofline_rows(records, mesh)
    assert len(got) == len(want) > 0
    scaled = 0
    for g, w in zip(got, want):
        # the reference multiplies a train cell by grad_accum (its cost
        # analysis counts the accumulation loop once); the port's eager
        # count is the whole step: divide the factor out of its row
        accum = 1
        if pregistry.SHAPES[w["shape"]].mode == "train":
            accum = max(pregistry.get(w["arch"]).config.grad_accum, 1)
        if accum == 1:
            assert g == w
            continue
        scaled += 1
        for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "hlo_flops_per_device"):
            assert g[k] == pytest.approx(w[k] / accum, rel=1e-12), k
        for k in ("useful_ratio", "roofline_fraction"):
            assert g[k] == pytest.approx(w[k] * accum, rel=1e-12), k
        assert {k: v for k, v in g.items() if not isinstance(v, float)} \
            == {k: v for k, v in w.items() if not isinstance(v, float)}
        assert g["model_flops_per_device"] == w["model_flops_per_device"]
        assert g["mem_gb_per_device"] == w["mem_gb_per_device"]
    assert scaled > 0
    assert roofline.corrected_costs(records) == jroof.corrected_costs(
        records)


def test_roofline_defaults_to_the_h100_model(capsys, tmp_path):
    records = _records()
    by_cell = {(r["arch"], r["shape"], r["mesh"]): r for r in records
               if not r.get("calibration") and not r.get("overrides")
               and r["status"] == "ok"}
    rows = [r for r in roofline.roofline_rows(records) if r["uncalibrated"]]
    assert rows
    for row in rows:
        rec = by_cell[(row["arch"], row["shape"], row["mesh"])]
        assert row["t_compute_s"] == rec["flops_per_device"] \
            / H100.peak_flops
        assert row["t_memory_s"] == rec["bytes_per_device"] / H100.mem_bw
        assert row["t_collective_s"] == rec[
            "collective_bytes_per_device"] / H100.link_bw
    path = tmp_path / "records.json"
    path.write_text(json.dumps(records))
    roofline.main(["--results", str(path)])
    out = capsys.readouterr().out
    assert "nvidia-h100" in out and "dom=" in out


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------
def test_cli_writes_resumes_and_exits_1_on_an_error(tmp_path, capsys):
    out = tmp_path / "sub" / "results.json"
    args = ["--arch", "qwen2_1_5b", "--shape", "decode_32k", "--mesh",
            "pod", "--out", str(out)]
    dryrun.main(args + ["--set", "n_layers=1"])
    recs = json.loads(out.read_text())
    assert [(r["status"], r["overrides"]) for r in recs] == [
        ("ok", {"n_layers": 1})]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(args + ["--set", "n_layers=1", "--set",
                            "attention_impl=bogus", "--shape",
                            "prefill_32k"])
    assert exc.value.code == 1
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok", "error"]
    assert "unknown attention impl" in recs[1]["error"]
    assert "dry-run complete: 1 ok, 1 errors" in capsys.readouterr().out
    assert dryrun.DEFAULT_OUT.startswith("build")


# ---------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def unit_jobs():
    """``run_cell`` of every one-unit cell on both meshes, started at the
    module's first test in six processes, the slowest first (DTensor's
    first trace of a train step on the multipod mesh takes it tens of
    seconds, most of them choosing each op's layouts); the tests that read
    the records come last."""
    jobs = sorted(((arch, shape_name, multi_pod)
                   for arch, shape_name in UNIT_CELLS
                   for multi_pod in (True, False)),
                  key=lambda job: (not job[2], not job[1].startswith("train"),
                                   job[0] != "recurrentgemma_2b"))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(6, mp_context=ctx) as pool:
        yield {job: pool.submit(dryrun.run_cell, *job,
                                extra_cfg=_unit(job[0]))
               for job in jobs}


@pytest.fixture(scope="module")
def unit_records(unit_jobs):
    return {job: f.result() for job, f in unit_jobs.items()}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,shape_name", UNIT_CELLS)
def test_one_unit_cells_are_ok(unit_records, arch, shape_name, multi_pod):
    rec = unit_records[(arch, shape_name, multi_pod)]
    assert rec["status"] == "ok", rec
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("multipod" if multi_pod else "pod")
    assert rec["mode"] == pregistry.SHAPES[shape_name].mode
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_count"] > 0
    assert set(rec["collectives"]) == set(dryrun._COLLECTIVES)
    assert rec["collective_bytes_per_device"] == sum(
        rec["collectives"].values())
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["trace_s"] >= 0


def test_train_loss_keeps_the_logits_split(unit_records):
    """qwen2 train_4k on the pod mesh: the (B, S, V) fp32 logits and
    their gradient stay split over all 256 devices (the batch over 'data',
    the vocab over 'model'), so the peak of live bytes is a few times one
    device's share B·S·V·4/256, well under the share with only the vocab
    split (B·S·V·4/16), let alone a whole replicated copy."""
    rec = unit_records[("qwen2_1_5b", "train_4k", False)]
    cfg, shape = pregistry.get("qwen2_1_5b").config, pregistry.SHAPES[
        "train_4k"]
    whole = shape.global_batch * shape.seq_len * cfg.vocab * 4
    assert rec["memory"]["temp_bytes"] < whole / 16 / 2


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "seamless_m4t_medium"])
def test_prefill_splits_its_work_over_every_device(unit_records, arch):
    """A prefill of 32 sequences splits its batch over every data-parallel
    axis ('data' on the pod mesh, 'pod' and 'data' on multipod) and its
    sequence over 'model': twice the devices do half the FLOPs each.
    seamless has ``grad_accum`` 2, whose microbatch the activation
    constraint must not take in prefill."""
    pod = unit_records[(arch, "prefill_32k", False)]
    multipod = unit_records[(arch, "prefill_32k", True)]
    assert multipod["flops_per_device"] < pod["flops_per_device"]
    assert pod["flops_per_device"] == pytest.approx(
        2 * multipod["flops_per_device"], rel=1e-6)


def test_argument_bytes_are_the_placed_leaves_local_bytes(unit_records):
    arch = pregistry.get("qwen2_1_5b")
    rec = unit_records[("qwen2_1_5b", "decode_32k", False)]
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, **_unit("qwen2_1_5b")))
    with pmesh.fake_process_group(256):
        mesh = pmesh.make_production_mesh(device_type="cpu")
        _, in_sh, _, donate, args = build_step(arch, "decode_32k", mesh)
        placed = [place(a, s) for a, s in zip(args, in_sh)]
        leaves = [t for t in dryrun._tensors(placed)]
        want = sum(t.to_local().numel() * t.to_local().element_size()
                   for t in leaves)
        alias = sum(t.to_local().numel() * t.to_local().element_size()
                    for i in donate for t in dryrun._tensors(placed[i]))
    assert rec["memory"]["argument_bytes"] == want > 0
    assert rec["memory"]["alias_bytes"] == alias > 0
    assert donate == (1,)
