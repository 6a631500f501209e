"""The port's phase placement, LM engines, link measurement and device
assignment against the JAX package's, on the CPU.

* ``place_phases``, ``phase_cost``, ``handoff_payload_bytes`` and
  ``drift_scaled_device`` give the JAX package's numbers to the last float,
  for every objective, on the engines both packages define (the paper
  boards' roofline twins) plus one engine each test builds on the TPU model
  both registries carry.
* The ``torch`` engine's LM builders (attention, MLP, MoE, SSM) match the
  ``xla`` engine's on the same numpy inputs and weights at fp32 2e-4, and
  their parameter layout is the JAX package's.
* ``hopper`` lists the kinds the JAX package's ``pallas`` engine lists, so
  a phase network schedules the same.
* ``measure_link_bandwidth`` copies into new storage; the cache keeps and
  finds link measurements; ``device_assignment`` shares the one device it
  sees and refuses an index out of range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_models as jdm
from repro.core import engines as jengines
from repro.core import scheduler as jscheduler
from repro.core.layer_model import AttentionSpec as JAttention
from repro.core.layer_model import MLPSpec as JMLP
from repro.core.layer_model import MoESpec as JMoE
from repro.core.layer_model import SSMSpec as JSSM
from repro.configs import qwen2_1_5b as jqwen
from repro.models import transformer as JT
from repro.serving import batcher as jbatcher
from repro.serving import placement as jplace
from repro_torch.configs import qwen2_1_5b as pqwen
from repro_torch.core import device_models as pdm
from repro_torch.core import engines as pengines
from repro_torch.core import scheduler as pscheduler
from repro_torch.core.layer_model import (AttentionSpec, MLPSpec, MoESpec,
                                          SSMSpec)
from repro_torch.launch import mesh
from repro_torch.models import transformer as PT
from repro_torch.profiling import (LINK_ENGINE, ProfileCache, cached_link_bw,
                                   measure_link_bandwidth, record_link_bw,
                                   validate_dict)
from repro_torch.profiling import transfer
from repro_torch.serving import batcher as pbatcher
from repro_torch.serving import placement as pplace

torch.set_num_threads(2)

_TINY = dict(name="place-tiny", n_layers=3, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab=64, attention_impl="dot")
# (port config, reference config) pairs: the reference tests' TINY, and
# qwen2-1.5B at full size
CONFIGS = {
    "tiny": (PT.ModelConfig(**_TINY), JT.ModelConfig(**_TINY, remat=False)),
    "qwen2": (pqwen.CONFIG, jqwen.CONFIG),
}
OBJECTIVES = ("latency", "energy", "edp", "perf_density")


def _tpu_engines():
    """An engine on the TPU model in each package (named alike), beside the
    two roofline boards both packages register."""
    port = (pengines.ExecutionEngine(
                name="tpu-test", device=pdm.TPU_V5E,
                kinds=pengines.TORCH_ENGINE.kinds, efficiency=0.55),
            pengines.K40_LM_ENGINE, pengines.DE5_LM_ENGINE)
    ref = (jengines.ExecutionEngine(
               name="tpu-test", device=jdm.TPU_V5E,
               kinds=jengines.XLA_ENGINE.kinds, efficiency=0.55),
           jengines.K40_LM_ENGINE, jengines.DE5_LM_ENGINE)
    return port, ref


def _score(p):
    return (dataclasses.astuple(p.prefill), dataclasses.astuple(p.decode),
            dataclasses.astuple(p.handoff), p.objective, p.value,
            p.total_time_s, p.total_energy_j, p.total_flops, p.colocated)


# ---------------------------------------------------------------- registry
def test_placement_engines_mirror_the_reference():
    assert ([e.name for e in pengines.PLACEMENT_ENGINES]
            == ["torch" if e.name == "xla" else e.name
                for e in jengines.PLACEMENT_ENGINES])
    assert pengines.TORCH_ENGINE.kinds == jengines.XLA_ENGINE.kinds
    assert pengines.HOPPER_ENGINE.kinds == jengines.PALLAS_ENGINE.kinds
    for name in ("k40-roofline", "de5-roofline"):
        got, want = (pengines.ENGINES_BY_NAME[name],
                     jengines.ENGINES_BY_NAME[name])
        assert (got.kinds, got.efficiency, got.buildable) == (
            want.kinds, want.efficiency, want.buildable)
        assert dataclasses.astuple(got.device) == dataclasses.astuple(
            want.device)
    with pytest.raises(NotImplementedError, match="hopper builder"):
        pengines.HOPPER_ENGINE.build(AttentionSpec(
            "a", d_model=32, n_heads=4, n_kv_heads=2, seq=1, kv_len=8))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_phase_networks_schedule_as_the_reference(objective):
    """hopper lists attention as pallas does: on one device model the two
    packages' engine pairs schedule a phase network the same."""
    port_cfg, ref_cfg = CONFIGS["tiny"]

    def engines(lib, dm, pair):
        return [lib.ExecutionEngine(name=f"e{i}", device=dm.TPU_V5E,
                                    kinds=e.kinds, efficiency=e.efficiency)
                for i, e in enumerate(pair)]

    for seq, kv in ((1, 48), (32, 32)):
        got = pscheduler.schedule(
            pbatcher.phase_network_spec(port_cfg, seq=seq, kv_len=kv),
            engines(pengines, pdm, pengines.DEFAULT_ENGINES),
            objective=objective, batch=4)
        want = jscheduler.schedule(
            jbatcher.phase_network_spec(ref_cfg, seq=seq, kv_len=kv),
            engines(jengines, jdm, jengines.DEFAULT_ENGINES),
            objective=objective, batch=4)
        assert ([a.engine for a in got.assignments]
                == [a.engine for a in want.assignments])
        assert got.total_time == want.total_time


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_place_phases_equals_the_reference(config, objective):
    port_cfg, ref_cfg = CONFIGS[config]
    port_eng, ref_eng = _tpu_engines()
    cases = [dict(prompt_len=256, gen_len=256, batch=8),
             dict(prompt_len=64, gen_len=64),
             dict(prompt_len=256, gen_len=256, batch=8, link_bw=10.0),
             dict(prompt_len=32, gen_len=96, batch=3, dtype_bytes=4,
                  link_bw=2.5e10)]
    for kw in cases:
        for engines in ((port_eng, ref_eng),
                        (port_eng[1:], ref_eng[1:])):
            got = pplace.place_phases(port_cfg, engines[0],
                                      objective=objective, **kw)
            want = jplace.place_phases(ref_cfg, engines[1],
                                       objective=objective, **kw)
            assert [_score(p) for p in got.ranked] == [
                _score(p) for p in want.ranked], kw
            assert got.summary() == want.summary()
            assert (got.prefill_engine, got.decode_engine,
                    got.colocated) == (want.prefill_engine,
                                       want.decode_engine, want.colocated)


def test_place_phases_on_the_default_engines_prices_the_torch_engine():
    """The port's default candidates are the reference's with ``torch`` (on
    the H100 model) in place of ``xla``; the two boards' rows are equal."""
    port_cfg, ref_cfg = CONFIGS["qwen2"]
    got = pplace.place_phases(port_cfg, objective="energy", prompt_len=128,
                              gen_len=32, batch=8)
    want = jplace.place_phases(ref_cfg, objective="energy", prompt_len=128,
                               gen_len=32, batch=8)
    assert len(got.ranked) == len(want.ranked) == 9
    boards = {"k40-roofline", "de5-roofline"}

    def board_rows(d):
        return sorted(_score(p) for p in d.ranked
                      if {p.prefill.engine, p.decode.engine} <= boards)

    assert board_rows(got) == board_rows(want)
    assert {p.prefill.device for p in got.ranked} == {
        "nvidia-h100", "nvidia-k40-roofline", "altera-de5-roofline"}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_phase_cost_and_payload_equal_the_reference(config):
    port_cfg, ref_cfg = CONFIGS[config]
    port_eng, ref_eng = _tpu_engines()
    for pe, je in zip(port_eng, ref_eng):
        for phase in ("prefill", "decode"):
            for kw in (dict(prompt_len=16, gen_len=8),
                       dict(prompt_len=128, gen_len=32, batch=8),
                       dict(prompt_len=7, gen_len=1, batch=2,
                            dtype_bytes=4)):
                got = pplace.phase_cost(port_cfg, pe, phase, **kw)
                want = jplace.phase_cost(ref_cfg, je, phase, **kw)
                assert dataclasses.astuple(got) == dataclasses.astuple(
                    want), (pe.name, phase, kw)
    for kw in (dict(prompt_len=64), dict(prompt_len=64, slot_len=128),
               dict(prompt_len=5, dtype_bytes=4, slot_len=20)):
        assert (pplace.handoff_payload_bytes(port_cfg, **kw)
                == jplace.handoff_payload_bytes(ref_cfg, **kw)), kw
    with pytest.raises(ValueError, match="does not run"):
        pplace.phase_cost(port_cfg, pengines.K40_ENGINE, "decode",
                          prompt_len=8, gen_len=8)
    with pytest.raises(ValueError, match="unknown phase"):
        pplace.phase_cost(port_cfg, pengines.TORCH_ENGINE, "train",
                          prompt_len=8, gen_len=8)


def test_drift_scaled_device_equals_the_reference():
    for ratio in (1e-6, 0.5, 3.0):
        got = pplace.drift_scaled_device(pdm.K40_ROOFLINE, ratio)
        want = jplace.drift_scaled_device(jdm.K40_ROOFLINE, ratio)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(ValueError):
        pplace.drift_scaled_device(pdm.H100, 0.0)


def test_placement_rejects_bad_arguments_and_degrades_without_cache(
        tmp_path):
    cfg = CONFIGS["tiny"][0]
    pair = (pengines.K40_LM_ENGINE, pengines.DE5_LM_ENGINE)
    with pytest.raises(ValueError, match="objective"):
        pplace.place_phases(cfg, pair, objective="power", prompt_len=8,
                            gen_len=8)
    with pytest.raises(ValueError, match="pricing"):
        pplace.place_phases(cfg, pair, price="guess", prompt_len=8,
                            gen_len=8)
    with pytest.raises(ValueError, match="no candidate"):
        pplace.place_phases(cfg, (pengines.K40_ENGINE,), prompt_len=8,
                            gen_len=8)
    measured = pplace.place_phases(
        cfg, pair, objective="energy", prompt_len=64, gen_len=64,
        price="measured", cache_path=str(tmp_path / "missing.json"),
        device="cpu")
    analytic = pplace.place_phases(cfg, pair, objective="energy",
                                   prompt_len=64, gen_len=64)
    assert [_score(p) for p in measured.ranked] == [
        _score(p) for p in analytic.ranked]
    assert measured.pricing == "measured"


def test_measured_placement_prices_the_handoff_at_the_cached_link(tmp_path):
    """A recorded link rate prices the hand-off of price="measured" (an
    explicit link_bw still wins)."""
    cfg = CONFIGS["tiny"][0]
    pair = (pengines.K40_LM_ENGINE, pengines.DE5_LM_ENGINE)
    path = str(tmp_path / "link.json")
    cache = ProfileCache(path, device="cpu")
    m = record_link_bw(cache, "cpu", "cpu", n_bytes=1 << 16, repeats=2)
    cache.save()
    kw = dict(objective="energy", prompt_len=64, gen_len=64)
    got = pplace.place_phases(cfg, pair, price="measured", cache_path=path,
                              device="cpu", **kw)
    want = pplace.place_phases(cfg, pair, link_bw=m["link_bw"], **kw)
    assert [_score(p) for p in got.ranked] == [_score(p)
                                               for p in want.ranked]
    split = [p for p in got.ranked if not p.colocated][0]
    assert split.handoff.link_bw == m["link_bw"]
    assert split.handoff.link_source == "provided"


# -------------------------------------------------------- LM builders
SPECS = [
    (AttentionSpec("a", d_model=32, n_heads=4, n_kv_heads=2, seq=1,
                   kv_len=16, qkv_bias=True),
     JAttention("a", d_model=32, n_heads=4, n_kv_heads=2, seq=1, kv_len=16,
                qkv_bias=True)),
    (AttentionSpec("p", d_model=32, n_heads=4, n_kv_heads=2, seq=6,
                   kv_len=10),
     JAttention("p", d_model=32, n_heads=4, n_kv_heads=2, seq=6,
                kv_len=10)),
    (MLPSpec("m", d_model=32, d_ff=64, seq=3),
     JMLP("m", d_model=32, d_ff=64, seq=3)),
    (MLPSpec("g", d_model=32, d_ff=64, seq=2, gated=False),
     JMLP("g", d_model=32, d_ff=64, seq=2, gated=False)),
    (MoESpec("e", d_model=32, d_ff=64, seq=2, n_experts=4, top_k=2),
     JMoE("e", d_model=32, d_ff=64, seq=2, n_experts=4, top_k=2)),
    (SSMSpec("s", d_model=32, d_state=8, d_conv=4, expand=2, seq=5,
             variant="mamba1"),
     JSSM("s", d_model=32, d_state=8, d_conv=4, expand=2, seq=5,
          variant="mamba1")),
    (SSMSpec("r", d_model=32, d_state=8, d_conv=4, expand=2, seq=5,
             variant="rglru"),
     JSSM("r", d_model=32, d_state=8, d_conv=4, expand=2, seq=5,
          variant="rglru")),
]


@pytest.mark.parametrize("pair", SPECS, ids=[s[0].name for s in SPECS])
def test_torch_lm_builders_match_the_xla_engine(pair):
    spec, jspec = pair
    want_params = jengines.init_layer_params(jspec, jax.random.PRNGKey(0))
    got_params = pengines.init_layer_params(
        spec, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got_params.items()} == {
        k: tuple(v.shape) for k, v in want_params.items()}
    assert pengines.param_shapes(spec) == {
        k: tuple(v.shape) for k, v in want_params.items()}
    for name in ("a_log", "d_skip", "a_param", "bq"):
        if name in want_params:            # the fixed (undrawn) ones
            np.testing.assert_allclose(got_params[name].numpy(),
                                       np.asarray(want_params[name]),
                                       rtol=1e-6, atol=0)
    rng = np.random.default_rng(1)
    params = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in want_params.items()}
    if "a_log" in params:
        params["a_log"] = np.array(want_params["a_log"])
    x = rng.standard_normal((2, spec.seq, spec.d_model)).astype(np.float32)
    want = np.asarray(jengines.XLA_ENGINE.build(jspec)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}))
    with torch.no_grad():
        got = pengines.TORCH_ENGINE.build(spec)(
            torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in params.items()}).numpy()
    assert got.shape == want.shape == (2, spec.seq, spec.d_model)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_lm_kinds_profile_and_calibrate_on_the_cpu():
    """The profiling harness times the phase network's kinds on the torch
    engine and calibrates a model covering them."""
    from repro_torch.profiling import calibrate_engine, profile_network
    net = pbatcher.phase_network_spec(CONFIGS["tiny"][0], seq=1, kv_len=16)
    ms = profile_network(net, [pengines.TORCH_ENGINE], batch=2, warmup=1,
                         repeats=2, device="cpu")
    assert {m.kind for m in ms} == {"attention", "mlp"}
    assert all(m.t_median > 0 for m in ms)
    model = calibrate_engine(pengines.TORCH_ENGINE, ms)
    assert set(model.throughput) == {"attention", "mlp"}


def test_cnn_init_is_unchanged_by_the_lm_layout():
    """The CNN kinds draw exactly what they drew before the LM kinds
    joined: He-normal filters and weights from the generator, zero
    biases."""
    from repro_torch.core.layer_model import alexnet_spec
    for spec in alexnet_spec():
        shapes = pengines.param_shapes(spec)
        if not shapes:
            continue
        gen = torch.Generator().manual_seed(3)
        got = pengines.init_layer_params(spec, gen)
        gen = torch.Generator().manual_seed(3)
        w = torch.randn(shapes["w"], generator=gen)
        fan_in = (shapes["w"][0] if len(shapes["w"]) == 2
                  else int(np.prod(shapes["w"][1:])))
        assert torch.equal(got["w"], w * (2.0 / fan_in) ** 0.5)
        assert torch.equal(got["b"], torch.zeros(shapes["b"]))


# ----------------------------------------------------------- link + mesh
def test_link_probe_copies_into_new_storage(monkeypatch):
    """The destination is allocated before the timing and the source is
    copied into it: a probe that only rebinds ``src.to(dst)`` (the same
    tensor on one device) would leave it as allocated."""
    made = []
    empty = torch.empty

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        t.fill_(float("nan"))
        made.append(t)
        return t

    monkeypatch.setattr(transfer.torch, "empty", spy)
    m = measure_link_bandwidth("cpu", "cpu", n_bytes=1 << 16, repeats=3)
    assert len(made) == 1 and made[0].numel() == (1 << 16) // 4
    assert torch.count_nonzero(made[0]) == 0     # the zeros arrived
    assert m["n_bytes"] == 1 << 16 and m["src"] == m["dst"] == "cpu:0"
    assert m["link_bw"] > 0 and m["t_median"] > 0
    assert (m["engine"], m["kind"], m["backend"]) == (LINK_ENGINE,
                                                      "transfer", "cpu")


def test_link_measurements_round_trip_through_the_cache(tmp_path):
    cache = ProfileCache(str(tmp_path / "c.json"), device="cpu")
    assert cached_link_bw(cache) is None
    small = record_link_bw(cache, "cpu", "cpu", n_bytes=1 << 12, repeats=2)
    big = record_link_bw(cache, "cpu", "cpu", n_bytes=1 << 16, repeats=2)
    assert small["fingerprint"] != big["fingerprint"]
    path = cache.save()
    loaded = ProfileCache.load(path, device="cpu")
    assert validate_dict({"schema": 1, "entries": loaded.entries}) == []
    # the largest, most amortized probe wins; labels filter
    assert cached_link_bw(loaded) == big["link_bw"]
    assert cached_link_bw(loaded, src="cuda:0") is None
    assert cached_link_bw(loaded, dst="cpu:0") == big["link_bw"]
    assert len(loaded.measurements(source="link-calibration")) == 2
    assert loaded.measurements(source="serving-telemetry") == []


def test_single_device_assignment_is_shared_and_indices_are_checked(
        monkeypatch):
    asn = mesh.device_assignment(backend="cpu")
    assert not asn.distinct
    assert asn.prefill == asn.decode == torch.device("cpu")
    assert asn.summary() == "prefill -> cpu:0, decode -> cpu:0 (shared)"
    with pytest.raises(ValueError, match="out of range"):
        mesh.device_assignment(decode_index=1, backend="cpu")
    with pytest.raises(ValueError, match="out of range"):
        mesh.device_assignment(prefill_index=-1, backend="cpu")
    assert mesh.device_label("cuda") == "cuda:0"
    assert mesh.device_label(torch.device("cuda", 3)) == "cuda:3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.visible_devices() == []
    with pytest.raises(RuntimeError, match="no cuda devices"):
        mesh.device_assignment()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = mesh.device_assignment()
    assert two.distinct and two.summary() == (
        "prefill -> cuda:0, decode -> cuda:1 (distinct)")
