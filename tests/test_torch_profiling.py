"""The port's profiling runtime (measured, profile-then-offload pricing)
against the JAX package's, on the CPU.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

The two packages are fed the same medians (``_MEDIANS``, from a numpy seed)
under their own engine names — the reference's ``xla``/``pallas``, the
port's ``torch``/``hopper`` — and must then agree exactly: the assignments
(names mapped), each layer's ``t_total``, ``fit_kind_rates`` and the layers
``reprice_plan`` moves.  The rest mirrors tests/test_profiling.py: the
cache's round trip and environment scoping (a measurement from another
card or torch is never a hit), measure-on-miss with persistence, the dtype
taken from ``dtype_bytes``, and ``compile_plan(price="measured")`` end to
end on ``tiny_net``, whose output is held to the reference's at fp32.
Every cache lives under ``tmp_path`` or in memory.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as jeng
from repro.core import scheduler as jsched
from repro.core.layer_model import alexnet_full_spec as j_alexnet
from repro.core.plan import compile_plan as j_compile_plan
from repro.core.plan import reprice_plan as j_reprice_plan
from repro.launch import profile as jprofile
from repro.profiling import MeasuredPricer as JMeasuredPricer
from repro.profiling import Measurement as JMeasurement
from repro.profiling import ProfileCache as JProfileCache
from repro.profiling import environment as j_environment
from repro.profiling import fingerprint as j_fingerprint
from repro.profiling import fit_kind_rates as j_fit_kind_rates
from repro_torch.core import engines as E
from repro_torch.core import scheduler
from repro_torch.core.cost_model import layer_cost
from repro_torch.core.layer_model import FCSpec, alexnet_full_spec
from repro_torch.core.plan import compile_plan, reprice_plan
from repro_torch.launch import profile as profile_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.profiling import (CalibratedDeviceModel, MeasuredPricer,
                                   Measurement, ProfileCache,
                                   analytic_predicted_time, calibrate_engine,
                                   calibration_report, environment,
                                   fingerprint, fit_kind_rates,
                                   profile_network, time_layer,
                                   validate_dict)

torch.set_num_threads(2)

TORCH, HOPPER = E.TORCH_ENGINE, E.HOPPER_ENGINE
TINY_FC = FCSpec("TFC", m_i=(8, 8, 8), k_o=16)
CPU_ENV = environment("cpu")
TO_PORT = {"xla": "torch", "pallas": "hopper"}
FP32_TOL = 2e-4                                  # tests/test_kernels.py


def _measurement(spec, engine, t_median, *, batch=1, env=None,
                 dtype="float32"):
    env = env or CPU_ENV
    return Measurement(
        layer=spec.name, kind=spec.kind, engine=engine, batch=batch,
        dtype=dtype, repeats=3, t_median=t_median, t_iqr=t_median * 0.1,
        t_min=t_median * 0.9, t_mean=t_median, flops=spec.flops(batch),
        fingerprint=fingerprint(spec, batch, dtype), **env)


def _j_measurement(spec, engine, t_median, *, batch=1):
    env = j_environment()
    return JMeasurement(
        layer=spec.name, kind=spec.kind, engine=engine, batch=batch,
        dtype="float32", repeats=3, t_median=t_median, t_iqr=t_median * 0.1,
        t_min=t_median * 0.9, t_mean=t_median, flops=spec.flops(batch),
        fingerprint=j_fingerprint(spec, batch, "float32"),
        jax_version=env["jax_version"], backend=env["backend"])


def _pricer(cache):
    return MeasuredPricer(cache, measure_on_miss=False, autosave=False,
                          device="cpu")


# ---------------------------------------------------------- fingerprint
def test_fingerprint_stable_sensitive_and_the_references():
    a = fingerprint(TINY_FC, 1, "float32")
    assert a == fingerprint(FCSpec("TFC", m_i=(8, 8, 8), k_o=16), 1,
                            "float32")
    assert a != fingerprint(FCSpec("TFC", m_i=(8, 8, 8), k_o=32), 1,
                            "float32")
    assert a != fingerprint(TINY_FC, 2, "float32")
    assert a != fingerprint(TINY_FC, 1, "bfloat16")
    # the port's layer tuples are the reference's: the same digests
    for mine, theirs in zip(alexnet_full_spec(), j_alexnet()):
        assert fingerprint(mine, 64, "float32") == j_fingerprint(
            theirs, 64, "float32")


# ---------------------------------------------------------------- cache
def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = ProfileCache(path, device="cpu")
    m = _measurement(TINY_FC, "torch", 1e-3)
    cache.put(m)
    cache.save()
    loaded = ProfileCache.load(path, device="cpu")
    hit = loaded.get(TINY_FC, "torch")
    assert hit is not None and Measurement.from_dict(hit) == m
    assert validate_dict(json.load(open(path))) == []
    assert set(CPU_ENV) == {"torch_version", "device_name", "capability"}


@pytest.mark.parametrize("stale", [
    {"torch_version": "0.0.1"},                        # another torch
    {"device_name": "NVIDIA A100-SXM4-80GB", "capability": "8.0"},  # card
])
def test_cache_measurement_from_another_environment_is_never_a_hit(
        tmp_path, stale):
    path = str(tmp_path / "cache.json")
    cache = ProfileCache(path, device="cpu")
    cache.put(_measurement(TINY_FC, "torch", 1e-3,
                           env={**CPU_ENV, **stale}))
    cache.save()
    loaded = ProfileCache.load(path, device="cpu")
    assert len(loaded) == 1
    # lookups are environment-scoped: the stale entry is invisible ...
    assert loaded.get(TINY_FC, "torch") is None
    assert loaded.measurements() == []
    assert len(loaded.measurements(stale=True)) == 1
    pricer = _pricer(loaded)
    assert pricer.price(TINY_FC, TORCH) is None and pricer.hits == 0
    # ... and invalidate_stale garbage-collects it
    assert loaded.invalidate_stale() == 1
    assert len(loaded) == 0


def _run_validate(*args):
    src = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.profiling.cache", "--validate",
         *args, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)


def test_cache_validate_cli_agrees_with_lookups(tmp_path):
    r = _run_validate(str(tmp_path / "nope.json"))
    assert r.returncode == 1 and "no such file" in (r.stdout + r.stderr)
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"schema": 1, "entries": {}}))
    r = _run_validate(str(empty))
    assert r.returncode == 1 and "no usable entries" in (r.stdout + r.stderr)
    assert _run_validate(str(empty), "--allow-empty").returncode == 0
    stale = ProfileCache(str(tmp_path / "stale.json"), device="cpu")
    stale.put(_measurement(TINY_FC, "torch", 1e-3,
                           env={**CPU_ENV, "device_name": "NVIDIA H100"}))
    assert _run_validate(stale.save()).returncode == 1
    good = ProfileCache(str(tmp_path / "good.json"), device="cpu")
    good.put(_measurement(TINY_FC, "torch", 1e-3))
    assert _run_validate(good.save()).returncode == 0


def test_cache_merge_and_invalidate():
    a, b = ProfileCache(device="cpu"), ProfileCache(device="cpu")
    a.put(_measurement(TINY_FC, "torch", 1e-3))
    b.put(_measurement(TINY_FC, "hopper", 2e-3))
    b.put(_measurement(TINY_FC, "torch", 5e-3))      # collision: b wins
    assert a.merge(b) == 2
    assert len(a) == 2
    assert a.get(TINY_FC, "torch")["t_median"] == 5e-3
    assert a.invalidate(engine="hopper") == 1
    assert a.invalidate() == 1


def test_cache_schema_validation_catches_corruption():
    assert validate_dict([]) != []
    assert validate_dict({"schema": 99, "entries": {}}) != []
    cache = ProfileCache(device="cpu")
    cache.put(_measurement(TINY_FC, "torch", 1e-3))
    good = {"schema": 1, "entries": cache.entries}
    assert validate_dict(good) == []
    for field, value in (("t_median", None), ("t_median", -1.0),
                         ("device_name", "other")):
        bad = json.loads(json.dumps(good))
        entry = next(iter(bad["entries"].values()))
        if value is None:
            entry.pop(field)
        else:
            entry[field] = value                 # key no longer matches
        assert validate_dict(bad) != [], field


# -------------------------------------------------------------- harness
@pytest.mark.parametrize("engine", [TORCH, HOPPER])
def test_time_layer_on_the_cpu(engine):
    m = time_layer(engine, TINY_FC, warmup=1, repeats=3, device="cpu")
    assert m.engine == engine.name and m.kind == "fc" and m.repeats == 3
    assert m.t_median > 0 and m.t_min <= m.t_median
    assert m.flops == TINY_FC.flops(1) and m.achieved_flops > 0
    assert (m.torch_version, m.device_name) == (torch.__version__, "cpu")


def test_time_layer_rejects_cost_only_engine():
    with pytest.raises(ValueError, match="cost-only"):
        time_layer(E.K40_ENGINE, TINY_FC, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_layer(TORCH, TINY_FC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_network(profile_cli.tiny_net(), [TORCH])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_cli.main(["--net", "tiny", "--cache",
                          str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()


def test_profile_network_uses_cache(tmp_path):
    net = profile_cli.tiny_net()
    cache = ProfileCache(str(tmp_path / "c.json"), device="cpu")
    first = profile_network(net, [TORCH], warmup=1, repeats=2, cache=cache,
                            device="cpu")
    assert len(first) == len(net)
    second = profile_network(net, [TORCH], cache=cache,
                             measure_on_miss=False, device="cpu")
    assert second == first
    with pytest.raises(ValueError, match="cache for"):
        profile_network(net, [TORCH], cache=ProfileCache(), device="cpu")


# ----------------------------------------------------------- calibrator
def test_calibrator_reduces_error_on_synthetic_timings():
    net = profile_cli.tiny_net()
    rates = {"conv": 3e9, "fc": 1e9}
    ms = [_measurement(s, "torch", s.flops(1) / rates[s.kind]) for s in net]
    rep = calibration_report(TORCH, list(net), ms)
    assert rep.calibrated_mape < rep.analytic_mape
    assert rep.calibrated_mape < 1e-9        # exact on rate-constant data
    for kind, fitted in rep.model.throughput.items():
        assert fitted == pytest.approx(rates[kind])


def test_calibrated_model_drops_into_cost_model():
    model = calibrate_engine(TORCH, [_measurement(TINY_FC, "torch", 1e-3)])
    assert isinstance(model, CalibratedDeviceModel) and not model.analytic
    assert model.name == "nvidia-h100-measured-torch"
    assert layer_cost(TINY_FC, model).t_total == pytest.approx(1e-3)
    # unmeasured kinds fall back to the engine's nominal efficiency
    assert model.achieved_flops("conv") == pytest.approx(
        TORCH.efficiency * TORCH.device.peak_flops)


# ------------------------------------------------- measured-price schedule
def _injected_medians():
    """(spec, median of engine a, median of engine b) for every AlexNet
    layer; three layers tie, where the first engine must win."""
    rng = np.random.default_rng(21)
    specs = list(alexnet_full_spec())
    t = rng.uniform(1e-5, 1e-3, size=(len(specs), 2))
    t[[2, 6, 11], 1] = t[[2, 6, 11], 0]
    return [(s, float(a), float(b)) for s, (a, b) in zip(specs, t)]


BATCH = 64


def _both_pricers():
    jcache, cache = JProfileCache(), ProfileCache(device="cpu")
    for (spec, a, b), jspec in zip(_injected_medians(), j_alexnet()):
        jcache.put(_j_measurement(jspec, "xla", a, batch=BATCH))
        jcache.put(_j_measurement(jspec, "pallas", b, batch=BATCH))
        cache.put(_measurement(spec, "torch", a, batch=BATCH))
        cache.put(_measurement(spec, "hopper", b, batch=BATCH))
    return (JMeasuredPricer(jcache, measure_on_miss=False, autosave=False),
            _pricer(cache))


def test_measured_schedule_equals_the_reference_exactly():
    jpricer, pricer = _both_pricers()
    jplan = jsched.schedule(j_alexnet(), jeng.DEFAULT_ENGINES, batch=BATCH,
                            price="measured", pricer=jpricer)
    plan = scheduler.schedule(alexnet_full_spec(), E.DEFAULT_ENGINES,
                              batch=BATCH, price="measured", pricer=pricer)
    assert plan.pricing == jplan.pricing == "measured"
    assert (plan.batch, plan.dtype_bytes) == (jplan.batch, jplan.dtype_bytes)
    assert [a.engine for a in plan.assignments] == \
        [TO_PORT[a.engine] for a in jplan.assignments]
    assert [a.cost.t_total for a in plan.assignments] == \
        [a.cost.t_total for a in jplan.assignments]
    # each layer on the engine with the smaller median, ties to the first
    for a, (_, t_torch, t_hopper) in zip(plan.assignments,
                                        _injected_medians()):
        assert a.engine == ("hopper" if t_hopper < t_torch else "torch")
    assert pricer.hits == jpricer.hits == 2 * len(plan.assignments)


def test_fit_kind_rates_equal_the_reference_exactly():
    jpricer, pricer = _both_pricers()
    for jname, name in TO_PORT.items():
        want = j_fit_kind_rates(JMeasurement.from_dict(m)
                                for m in jpricer.cache.measurements(
                                    engine=jname))
        got = fit_kind_rates(Measurement.from_dict(m)
                             for m in pricer.cache.measurements(engine=name))
        assert got == want and set(got) == {"conv", "norm", "pool", "fc"}


def test_reprice_plan_moves_the_layers_the_reference_moves():
    jpricer, pricer = _both_pricers()
    # from a plan that collapsed onto the first engine, in both packages
    jplan = jsched.schedule(j_alexnet(), [jeng.XLA_ENGINE], batch=BATCH)
    plan = scheduler.schedule(alexnet_full_spec(), [TORCH], batch=BATCH)
    jnew = j_reprice_plan(jplan, pricer=jpricer)
    new = reprice_plan(plan, pricer=pricer)
    jmoved = [a.spec.name for a, b in zip(jplan.assignments,
                                          jnew.assignments)
              if a.engine != b.engine]
    moved = [a.spec.name for a, b in zip(plan.assignments, new.assignments)
             if a.engine != b.engine]
    assert moved == jmoved and moved
    assert [a.cost.t_total for a in new.assignments] == \
        [a.cost.t_total for a in jnew.assignments]
    # compile_plan re-prices the same way
    assert compile_plan(plan, price="measured", pricer=pricer).plan == new


def test_measured_plan_agrees_with_analytic_when_measurements_match():
    net = profile_cli.tiny_net()
    cache = ProfileCache(device="cpu")
    for eng in E.DEFAULT_ENGINES:
        for spec in net:
            cache.put(_measurement(spec, eng.name,
                                   analytic_predicted_time(spec, eng)))
    pricer = _pricer(cache)
    plan_a = scheduler.schedule(net, E.DEFAULT_ENGINES)
    plan_m = scheduler.schedule(net, E.DEFAULT_ENGINES, price="measured",
                                pricer=pricer)
    assert plan_a.pricing == "analytic" and plan_m.pricing == "measured"
    assert [a.engine for a in plan_a.assignments] == \
        [a.engine for a in plan_m.assignments]
    for a, b in zip(plan_a.assignments, plan_m.assignments):
        assert b.cost.t_total == pytest.approx(a.cost.t_total)
    assert pricer.hits == len(net) * len(E.DEFAULT_ENGINES)


def test_measured_pricer_measures_on_miss_and_persists(tmp_path):
    path = str(tmp_path / "c.json")
    pricer = MeasuredPricer(ProfileCache(path, device="cpu"), warmup=1,
                            repeats=2, device="cpu")
    cost = pricer.price(TINY_FC, TORCH)
    assert cost is not None and cost.t_total > 0
    assert (pricer.hits, pricer.misses) == (0, 1)
    assert ProfileCache.load(path, device="cpu").get(TINY_FC,
                                                     "torch") is not None
    pricer.price(TINY_FC, TORCH)
    assert (pricer.hits, pricer.misses) == (1, 1)
    # unmeasurable requests decline -> scheduler falls back to analytic
    assert pricer.price(TINY_FC, TORCH, direction="bwd") is None
    assert pricer.price(TINY_FC, TORCH, n_chips=2) is None
    assert pricer.price(TINY_FC, E.K40_ENGINE) is None


def test_pricer_derives_dtype_from_dtype_bytes():
    cache = ProfileCache(device="cpu")
    cache.put(_measurement(TINY_FC, "torch", 1e-3))      # float32
    pricer = _pricer(cache)
    assert pricer.price(TINY_FC, TORCH, dtype_bytes=4) is not None
    # a bf16-priced schedule must not be fed float32 timings
    assert pricer.price(TINY_FC, TORCH, dtype_bytes=2) is None
    assert pricer.price(TINY_FC, TORCH, dtype_bytes=3) is None
    cache.put(_measurement(TINY_FC, "torch", 2e-3, dtype="bfloat16"))
    assert pricer.price(TINY_FC, TORCH, dtype_bytes=2).t_total == 2e-3


def test_plan_records_operating_point_and_reprice_preserves_it():
    net = profile_cli.tiny_net()
    plan = scheduler.schedule(net, E.DEFAULT_ENGINES, batch=3)
    assert (plan.batch, plan.dtype_bytes) == (3, 4)
    cache = ProfileCache(device="cpu")
    for eng in E.DEFAULT_ENGINES:
        for spec in net:
            cache.put(_measurement(spec, eng.name, 1e-3, batch=3))
    pricer = _pricer(cache)
    replan = reprice_plan(plan, pricer=pricer)
    assert (replan.batch, replan.dtype_bytes) == (3, 4)
    assert pricer.hits == len(net) * len(E.DEFAULT_ENGINES)


def test_compile_plan_measured_end_to_end_matches_the_reference(tmp_path):
    net = profile_cli.tiny_net()
    rng = np.random.default_rng(3)
    arrays = [{name: (rng.standard_normal(shape) * 0.3).astype(np.float32)
               if name == "w" else
               (0.1 * rng.standard_normal(shape)).astype(np.float32)
               for name, shape in E.param_shapes(spec).items()}
              for spec in net]
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    # the port measures on the CPU, on a miss
    pricer = MeasuredPricer(ProfileCache(str(tmp_path / "c.json"),
                                         device="cpu"),
                            warmup=1, repeats=2, device="cpu")
    plan = scheduler.schedule(net, E.DEFAULT_ENGINES)
    fn = compile_plan(plan, price="measured", pricer=pricer)
    assert fn.plan.pricing == "measured" and pricer.misses == 4
    y = fn(torch.from_numpy(x), params_from_numpy(net, arrays,
                                                  device="cpu"))
    # the reference, priced from injected medians (its xla engine faster)
    jnet = jprofile.tiny_net()
    jcache = JProfileCache()
    for spec in jnet:
        jcache.put(_j_measurement(spec, "xla", 1e-3))
        jcache.put(_j_measurement(spec, "pallas", 2e-3))
    jfn = j_compile_plan(
        jsched.schedule(jnet, jeng.DEFAULT_ENGINES), price="measured",
        pricer=JMeasuredPricer(jcache, measure_on_miss=False,
                               autosave=False))
    want = jfn(jnp.asarray(x), [{k: jnp.asarray(v) for k, v in a.items()}
                               for a in arrays])
    assert y.shape == (2, 16) and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=FP32_TOL,
                               atol=FP32_TOL)
    # already-measured plans are not re-priced
    assert compile_plan(fn.plan, price="measured", pricer=pricer).plan \
        is fn.plan


# ------------------------------------------------------------------ CLI
def test_profile_cli_has_the_references_flags_and_device():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    assert flags(profile_cli.build_parser()) == \
        flags(jprofile.build_parser()) | {"--device"}
    assert profile_cli.build_parser().parse_args([]).device == "cuda"
    assert sorted(profile_cli.NETS) == sorted(jprofile.NETS)


def test_profile_cli_runs_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "c.json"
    profile_cli.main(["--device", "cpu", "--net", "tiny", "--repeats", "2",
                      "--warmup", "1", "--cache", str(path)])
    out = capsys.readouterr().out
    assert "MAPE analytic" in out and "measured pricing (4 cache hits" in out
    assert len(ProfileCache.load(str(path), device="cpu")) == 4


# ---------------------------------------------------------------- bench
def test_profiling_bench_writes_the_references_keys(tmp_path):
    from benchmarks import bench_torch_profiling
    out = tmp_path / "bench.json"
    bench_torch_profiling.main(["--scale", "tiny", "--device", "cpu",
                                "--repeats", "2", "--cache",
                                str(tmp_path / "c.json"), "--out", str(out)])
    got = json.load(open(out))
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_profiling.json")) as f:
        want = json.load(f)

    def keys(d, depth):
        if depth == 0 or not isinstance(d, dict):
            return set()
        return {k for k in d} | {f"{k}.{sub}" for k, v in d.items()
                                 for sub in keys(v, depth - 1)}
    # the reference's keys, with its engines' names and its environment's
    # fields (jax version, backend) in the port's terms
    rename = {"xla": "torch", "pallas": "hopper", "jax_version":
              "torch_version", "backend": "device_name"}
    ref_keys = {".".join(rename.get(p, p) for p in k.split("."))
                for k in keys(want, 3)}
    assert ref_keys <= keys(got, 3)
    assert got["config"]["capability"] == "none"
    assert got["plans"]["measured"]["assignments"].keys() == {"TConv", "TFC"}
