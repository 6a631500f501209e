"""The port's performance watchdog, latency curves and telemetry feedback
against the JAX package's, on the CPU.

* ``obs.curves``: ``isotonic_fit``, ``fit_latency_curve``,
  ``LatencyCurve.predict``/``max_batch_within``/``summary`` and
  ``median_points`` equal the JAX package's exactly on seeded point sets.
* ``PerfWatchdog``: one burst timeline, drawn with numpy from a seed, fed to
  both watchdogs gives the same alerts, re-prices, ``step_time_fn`` (source
  and values), ``sync_cadence`` and ``report()``, exactly.  The timelines
  are tests/test_obs.py's fuzz scenarios, run through its own
  ``_simulate_watchdog`` (imported, not copied) once with each package's
  class, and a stream over many batch sizes with drain syncs.
* ``TelemetryFeedback``: the same bursts give the same cache entries (the
  environment fields and the engine's name aside: the port files them
  under torch's environment and engine "torch", the JAX package under
  jax's and "xla"), and the port's flush into its own ``ProfileCache``
  reads back through ``curve_points_from_cache`` as the JAX package's does
  from its cache.
* ``serve()`` at float32 on the SMOKE qwen2 with one set of weights:
  ``--watchdog --misprice`` (a price that pins the token budget to 1) alerts
  "fast", re-prices and re-opens the budget, with the unwatched run's and
  the JAX package's tokens; ``--feed-cache`` then ``--persist-curves``
  primes the second run's pricing from the first run's telemetry; a
  speculating run under the watchdog times its rounds and keeps plain
  decoding's tokens.  Alert times come from a real clock, so the two
  packages are compared on tokens and final budgets only.  A bf16 run's
  telemetry is filed and looked up under "bfloat16"; a streaming run whose
  drain syncs are made to look costly stretches the sync cadence, and its
  deltas still join up to the completion rows.
* The flash kernel takes the head dim of every config with attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serving.api as japi
import test_obs                      # the JAX package's fuzz scenarios
from repro.configs import qwen2_1_5b as jcfgs
from repro.configs import registry as jregistry
from repro.core import device_models as jdevices
from repro.models import transformer as JT
from repro.obs import curves as jcurves
from repro.profiling.cache import ProfileCache as JCache
from repro.serving.batcher import step_time_model as j_step_time_model
from repro_torch.configs import qwen2_1_5b as pcfgs
from repro_torch.configs import registry as pregistry
from repro_torch.core import device_models as pdevices
from repro_torch.kernels import flash_attention
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import PerfWatchdog, TelemetryFeedback
from repro_torch.obs import curves as pcurves
from repro_torch.profiling.cache import ProfileCache as PCache
from repro_torch.serving import api as papi
from repro_torch.serving import speculative as pspec
from repro_torch.serving.batcher import step_time_model as p_step_time_model

torch.set_num_threads(2)

JCFG = dataclasses.replace(jcfgs.SMOKE, compute_dtype=jnp.float32)
PCFG = dataclasses.replace(pcfgs.SMOKE, compute_dtype=torch.float32)
# the environment fields and the engine each package files telemetry under
J_ENV, P_ENV = ("jax_version", "backend"), ("torch_version", "device_name",
                                            "capability")


# ---------------------------------------------------------------------
# curves
# ---------------------------------------------------------------------
def _points(seed):
    """{batch: seconds}: a noisy rising curve with a few non-monotone
    knots, a zero time and a batch 0 (both dropped by the fit)."""
    rng = np.random.default_rng(seed)
    batches = rng.choice(np.arange(1, 33), size=rng.integers(3, 12),
                         replace=False)
    pts = {int(b): float(1e-3 * (1 + 0.2 * b) * rng.lognormal(0, 0.3))
           for b in batches}
    pts[0] = 1e-3
    pts[int(rng.integers(33, 40))] = 0.0
    return pts


@pytest.mark.parametrize("seed", range(5))
def test_isotonic_fit_equals_the_reference(seed):
    ys = np.random.default_rng(seed).lognormal(0, 0.5, size=20).tolist()
    assert pcurves.isotonic_fit(ys) == jcurves.isotonic_fit(ys)


@pytest.mark.parametrize("seed", range(5))
def test_fitted_curve_equals_the_reference(seed):
    pts = _points(seed)
    got = pcurves.fit_latency_curve(pts)
    want = jcurves.fit_latency_curve(pts)
    assert (got.batches, got.step_s, got.raw_step_s, got.source) == (
        want.batches, want.step_s, want.raw_step_s, want.source)
    assert got.summary() == want.summary()
    assert got.residuals() == want.residuals()
    for n in range(0, 45):                 # inside and past the knots
        assert got.predict(n) == want.predict(n)
    for slo in (1e-3, 3e-3, 5e-3, 1e-2, 1.0):
        for slots in (1, 3, 8, 32):
            assert (got.max_batch_within(slo, slots)
                    == want.max_batch_within(slo, slots))
    samples = {b: [t, 2 * t, 0.5 * t] for b, t in pts.items()}
    assert pcurves.median_points(samples) == jcurves.median_points(samples)
    one = {min(b for b in pts if b > 0): 1e-3}
    assert pcurves.fit_latency_curve(one) is None
    assert jcurves.fit_latency_curve(one) is None


# ---------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------
def _same_watchdogs(got, want, analytic=lambda n: 2e-4 * (1 + n)):
    assert [a.to_dict() for a in got.alerts] == [a.to_dict()
                                                 for a in want.alerts]
    assert got.reprices == want.reprices
    assert got.report() == want.report()
    assert got.sync_cadence() == want.sync_cadence()
    for engine, phase in {k for k in want._states}:
        fn, source = got.step_time_fn(engine, phase, analytic)
        jfn, jsource = want.step_time_fn(engine, phase, analytic)
        assert source == jsource
        assert [fn(n) for n in range(1, 17)] == [jfn(n)
                                                  for n in range(1, 17)]


# tests/test_obs.py's fuzz scenarios (the keyword arguments of its
# _simulate_watchdog in each of its tests)
SCENARIOS = {
    "no-false-positives": {},
    "tight-gate-heavy-noise": {"gate": 1.05, "noise": 0.2},
    "2x-drift": {"drift_at": 20, "drift_factor": 2.0},
    "inverse-drift": {"drift_at": 20, "drift_factor": 0.4},
    "ramp": {"drift_at": 20, "ramp_to": 3.0},
    "warmup-ordering": {"drift_at": 0, "drift_factor": 4.0,
                        "reprice": False},
    "long-warmup": {"warmup": 12, "drift_at": 20, "drift_factor": 2.0,
                    "n_bursts": 80},
    "low-alpha": {"alpha": 0.1, "drift_at": 20, "drift_factor": 3.0},
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_watchdog_equals_the_reference_on_the_fuzz_scenarios(scenario,
                                                             monkeypatch):
    kwargs = SCENARIOS[scenario]
    for seed in range(4):
        want, want_det = test_obs._simulate_watchdog(seed, **kwargs)
        with monkeypatch.context() as m:
            # _simulate_watchdog looks the class up in repro.obs when it runs
            m.setattr(jobs, "PerfWatchdog", PerfWatchdog)
            got, got_det = test_obs._simulate_watchdog(seed, **kwargs)
        assert isinstance(got, PerfWatchdog)
        assert [(i, a.to_dict()) for i, a in got_det] == [
            (i, a.to_dict()) for i, a in want_det]
        _same_watchdogs(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_watchdog_equals_the_reference_over_batch_sizes_and_syncs(seed):
    """Bursts at batch sizes 1-12 (several power-of-two buckets, each
    skipped once), a price that drifts, re-prices of every alert and drain
    syncs that come to dominate: the same alerts, curves and cadence."""
    rng = np.random.default_rng(seed)
    got, want = PerfWatchdog(), jobs.PerfWatchdog()
    for i in range(120):
        n = int(rng.integers(1, 13))
        steps = int(rng.integers(1, 17))
        price = 1e-3 * (1 + 0.1 * n) * (3.0 if 40 <= i < 80 else 1.0)
        elapsed = 1e-3 * (1 + 0.05 * n) * steps * rng.lognormal(0, 0.1)
        phase = "decode" if i % 5 else "prefill"
        alerts = [wd.observe_burst("colocated", phase, n_tokens=n,
                                   steps=steps, elapsed_s=elapsed,
                                   priced_step_s=price)
                  for wd in (got, want)]
        assert (alerts[0] is None) == (alerts[1] is None)
        if alerts[1] is not None:
            assert alerts[0].to_dict() == alerts[1].to_dict()
            for wd, a in zip((got, want), alerts):
                wd.note_reprice(a, {"pricing": "fitted-curve",
                                    "token_budget": n})
        sync = float(elapsed * rng.uniform(0.0, 0.05 if i < 60 else 2.0))
        for wd in (got, want):
            wd.observe_sync(sync)
    assert got.alerts and got.reprices
    _same_watchdogs(got, want)


# ---------------------------------------------------------------------
# telemetry feedback
# ---------------------------------------------------------------------
def _bursts(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 9)), int(rng.integers(0, 9)),
             float(rng.lognormal(-5, 0.5))) for _ in range(40)]


@pytest.mark.parametrize("seed", range(3))
def test_feedback_equals_the_reference(seed):
    kv_len = 48
    got = TelemetryFeedback(PCFG, kv_len=kv_len, device="cpu")
    want = jobs.TelemetryFeedback(JCFG, kv_len=kv_len)
    for n, steps, dt in _bursts(seed):
        got.observe_burst(n, steps, dt)
        want.observe_burst(n, steps, dt)
    assert got.batches == want.batches and got.n_bursts == want.n_bursts
    mine, theirs = got.measurements(), want.measurements()
    assert len(mine) == len(theirs) > 0
    for m, t in zip(mine, theirs):
        assert {k: m[k] for k in P_ENV} == PCache(device="cpu").env
        assert (m["engine"], t["engine"]) == ("torch", "xla")
        common = sorted(set(t) - set(J_ENV) - {"engine"})
        assert sorted(set(m) - set(P_ENV) - {"engine"}) == common
        for k in common:
            if isinstance(t[k], float):
                assert m[k] == pytest.approx(t[k], rel=1e-12, abs=0), k
            else:
                assert m[k] == t[k], k
    pcache, jcache = PCache(device="cpu"), JCache()
    assert got.flush(pcache) == want.flush(jcache) == len(mine)
    pts = pcurves.curve_points_from_cache(pcache, PCFG, kv_len=kv_len)
    jpts = jcurves.curve_points_from_cache(jcache, JCFG, kv_len=kv_len)
    assert sorted(pts) == sorted(jpts) == got.batches
    for b in jpts:
        assert pts[b] == pytest.approx(jpts[b], rel=1e-12)
    # entries filed under another device's environment are not read back
    other = PCache(device="cpu")
    other._env = dict(other.env, device_name="another card")
    other.entries = dict(pcache.entries)
    assert pcurves.curve_points_from_cache(other, PCFG, kv_len=kv_len) == {}


# ---------------------------------------------------------------------
# serve() with the watchdog, the feedback and the curves
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   JCFG))

    def redraw(path, a):  # norms and biases start at zero: give them values
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name in ("final_norm", "bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(PCFG, tree, device="cpu"))


@pytest.fixture
def float32_smoke(monkeypatch, weights, tmp_path):
    """Both packages serve the float32 SMOKE qwen2 on the same weights, in
    a scratch directory (the caches these options write)."""
    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=JCFG))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=PCFG))
    monkeypatch.setattr(japi, "build_params", lambda cfg, mesh: weights[0])
    monkeypatch.setattr(papi, "build_params", lambda cfg, dev: weights[1])
    monkeypatch.chdir(tmp_path)


def _opts(api, **fields):
    o = api.ServeOptions()
    groups = o.flat_fields()
    for name, value in fields.items():
        setattr(getattr(o, groups[name]), name, value)
    return o


# 12 requests: at a budget of 1 each is one burst, enough for the skipped
# cold burst, the warm-up and an alert with requests left to re-admit
WORKLOAD = dict(requests=12, prompt_len=8, gen_len=8, rate=1e9, slots=3)
STEP_SLO_MS = 500.0


def _misprice(step_time_model, cfg, device):
    """The factor that prices a 2-token step at 100x the step SLO, so that
    admission pins the token budget to 1 (tests/test_obs.py's choice)."""
    max_len = WORKLOAD["prompt_len"] + WORKLOAD["gen_len"]
    return (100.0 * STEP_SLO_MS / 1e3
            / step_time_model(cfg, max_len, 2, device=device))


def test_misprice_is_detected_and_repriced_with_unchanged_tokens(
        float32_smoke):
    watched = dict(WORKLOAD, watchdog=True, step_slo_ms=STEP_SLO_MS)
    got = papi.serve(_opts(papi, **watched, misprice=_misprice(
        p_step_time_model, PCFG, pdevices.get("nvidia-h100"))), device="cpu")
    plain = papi.serve(_opts(papi, **WORKLOAD), device="cpu")
    want = japi.serve(_opts(japi, **watched, misprice=_misprice(
        j_step_time_model, JCFG, jdevices.get("tpu-v5e"))))
    rep = got.watchdog
    assert len(rep["alerts"]) >= 1 and len(rep["reprices"]) >= 1
    assert rep["alerts"][0]["direction"] == "fast"
    assert rep["reprices"][0]["token_budget_old"] == 1
    admission = got.admission[0]
    assert admission["token_budget"] == WORKLOAD["slots"]
    assert admission["price_source"] in ("scaled-analytic", "fitted-curve")
    assert got.outputs == plain.outputs == want.outputs
    assert admission["token_budget"] == want.admission[0]["token_budget"]
    assert got.summary["requests_done"] == WORKLOAD["requests"]


def test_fed_cache_primes_the_next_runs_curve(float32_smoke, tmp_path):
    path = str(tmp_path / "curves.json")
    first = papi.serve(_opts(papi, **WORKLOAD, feed_cache=path),
                       device="cpu")
    assert first.admission[0]["price_source"] == "analytic"
    cache = PCache.load(path, device="cpu")
    fed = cache.measurements(source="serving-telemetry")
    assert fed and {m["engine"] for m in fed} == {"torch"}
    points = pcurves.curve_points_from_cache(
        cache, PCFG, kv_len=WORKLOAD["prompt_len"] + WORKLOAD["gen_len"])
    assert len(points) >= 2
    second = papi.serve(_opts(papi, **WORKLOAD, persist_curves=path),
                        device="cpu")
    assert second.admission[0]["price_source"] == "cache-curve"
    assert second.admission[0]["n_reprices"] == 1
    want = japi.serve(_opts(japi, **WORKLOAD))
    assert first.outputs == second.outputs == want.outputs


def test_speculating_run_under_the_watchdog_times_its_rounds(
        float32_smoke, monkeypatch):
    observed, inside = [], []
    spec_dispatch = pspec.spec_dispatch
    observe = PerfWatchdog.observe_burst

    def counted_dispatch(*args, **kwargs):
        inside.append(True)
        try:
            return spec_dispatch(*args, **kwargs)
        finally:
            inside.pop()

    def counted_observe(self, *args, **kwargs):
        if inside:
            observed.append(kwargs["steps"])
        return observe(self, *args, **kwargs)

    monkeypatch.setattr(pspec, "spec_dispatch", counted_dispatch)
    monkeypatch.setattr(PerfWatchdog, "observe_burst", counted_observe)
    spec = dict(WORKLOAD, speculate=True, draft_k=2, watchdog=True)
    got = papi.serve(_opts(papi, **spec), device="cpu")
    plain = papi.serve(_opts(papi, **WORKLOAD), device="cpu")
    want = japi.serve(_opts(japi, **spec))
    rounds = got.speculation["n_rounds"]
    assert rounds > 0 and len(observed) == rounds
    assert got.watchdog["streams"]["colocated/decode"]["batches_observed"]
    assert got.outputs == plain.outputs == want.outputs


def test_fed_entries_carry_the_served_compute_dtype(float32_smoke,
                                                    monkeypatch, tmp_path):
    """A bf16 run files its telemetry under "bfloat16", the dtype a
    bf16-priced lookup asks for, and primes the next bf16 run from it; a
    float32 lookup of the same cache finds nothing."""
    bf16 = dataclasses.replace(PCFG, compute_dtype=torch.bfloat16)
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=bf16))
    path = str(tmp_path / "curves.json")
    kv_len = WORKLOAD["prompt_len"] + WORKLOAD["gen_len"]
    first = papi.serve(_opts(papi, **WORKLOAD, feed_cache=path),
                       device="cpu")
    cache = PCache.load(path, device="cpu")
    fed = cache.measurements(source="serving-telemetry")
    assert fed and {m["dtype"] for m in fed} == {"bfloat16"}
    assert len(pcurves.curve_points_from_cache(
        cache, bf16, kv_len=kv_len, dtype="bfloat16")) >= 2
    assert pcurves.curve_points_from_cache(cache, bf16, kv_len=kv_len) == {}
    second = papi.serve(_opts(papi, **WORKLOAD, persist_curves=path),
                        device="cpu")
    assert second.admission[0]["price_source"] == "cache-curve"
    assert first.outputs == second.outputs


def test_streaming_under_sync_pressure_stretches_the_cadence(
        float32_smoke, monkeypatch):
    """Drain syncs priced far above the bursts (10 s added to each) make
    the watchdog stretch the streaming sink's cadence, so some boundaries
    skip their drain; the streamed deltas still join up to each request's
    completion row, each request's last delta is its only ``done`` one,
    TTFT stays at or above ttft_dispatch, and the tokens are the unwatched
    run's and the JAX package's."""
    from repro_torch.serving import driver as pdriver
    observe_sync = PerfWatchdog.observe_sync
    act = pdriver.OpenLoopDriver._act_on_watchdog
    cadences, drains = [], []

    def slow_sync(self, elapsed_s):
        drains.append(elapsed_s)
        return observe_sync(self, elapsed_s + 10.0)

    def recorded_act(self, sink):
        act(self, sink)
        cadences.append(sink.sync_every)

    monkeypatch.setattr(PerfWatchdog, "observe_sync", slow_sync)
    monkeypatch.setattr(pdriver.OpenLoopDriver, "_act_on_watchdog",
                        recorded_act)
    deltas = []
    got = papi.serve(_opts(papi, **WORKLOAD, watchdog=True), device="cpu",
                     on_delta=deltas.append)
    plain = papi.serve(_opts(papi, **WORKLOAD), device="cpu")
    want = japi.serve(_opts(japi, **WORKLOAD))
    assert max(cadences) > 1 and len(drains) < len(cadences)
    assert got.watchdog["sync_cadence"] > 1
    for r in got.requests:
        mine = [d for d in deltas if d.rid == r.rid]
        assert [t for d in mine for t in d.tokens] == r.output
        assert [d.done for d in mine] == [False] * (len(mine) - 1) + [True]
        assert r.ttft >= r.ttft_dispatch
    assert got.outputs == plain.outputs == want.outputs


# ---------------------------------------------------------------------
# the flash kernel's head dims
# ---------------------------------------------------------------------
def test_flash_head_dims_cover_every_config_with_attention():
    for name in pregistry.ARCH_NAMES:
        arch = pregistry.get(name)
        for cfg in (arch.config, arch.smoke):
            if cfg is None:
                continue
            cfgs = [cfg] + ([PT.encoder_config(cfg)]
                            if cfg.encoder_decoder else [])
            for c in cfgs:
                if {"attn", "xattn"} & set(c.layer_types()):
                    assert c.hd in flash_attention.HEAD_DIMS, (name, c.name,
                                                               c.hd)
