"""The port's serving entry point against the JAX package's, on the CPU.

* The options tree, ``EFFECTIVE_DEFAULTS`` and the CLI parser equal the JAX
  package's, but for the two defaults that name a TPU (the calibrated
  engine, the admission device model) and the port's extra ``--device``.
* ``validate()`` accepts and rejects exactly what the JAX package's does:
  tests/test_api.py's cases, copied, and a few hundred random option sets
  run through both.  Valid options whose modules are not ported raise
  ``NotImplementedError`` in ``serve``, naming their ROADMAP item; the
  placement options (item 4), ``--speculate`` (item 5) and the watchdog,
  telemetry feedback and persisted curves (item 6, colocated and
  disaggregated), ported, serve.
* ``serve(..., device="cpu")`` at float32 with the same weights gives the
  JAX package's ``serve()`` tokens, continuous (paged and dense) and static;
  its ``--trace`` output passes benchmarks/check_regression.py's gate, and
  the SLO rows, the trace export and the registry equal the JAX package's.

Each package's ``build_params`` and registry entry are monkeypatched so both
serve the SMOKE qwen2 in float32 on one set of weights (carried into the
port by ``params_from_numpy``).  The JAX package's static server draws its
prompts with ``jax.random``; the test hands it the port's numpy prompts.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from benchmarks.check_regression import validate_trace
from repro.configs import qwen2_1_5b as jcfgs
from repro.configs import registry as jregistry
from repro.launch.serve import build_parser as j_build_parser
from repro.models import transformer as JT
from repro.obs.export import chrome_trace as j_chrome_trace
from repro.obs.watchdog import slo_attainment as j_slo_attainment
from repro_torch.configs import qwen2_1_5b as pcfgs
from repro_torch.configs import registry as pregistry
from repro_torch.launch import serve as pserve_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import Tracer, chrome_trace, slo_attainment
from repro_torch.serving import api as papi
from repro_torch.serving.request import Request

torch.set_num_threads(2)

JCFG = dataclasses.replace(jcfgs.SMOKE, compute_dtype=jnp.float32)
PCFG = dataclasses.replace(pcfgs.SMOKE, compute_dtype=torch.float32)
# the two defaults that name a TPU in the JAX package, and what they name
# here: the admission device model (an option's default) and the engine
# --calibrated-cache reads (an effective default)
DEVICE_MODEL = ("tpu-v5e", "nvidia-h100")
CALIBRATED_ENGINE = ("xla", "torch")


def _opts(api, **overrides):
    """ServeOptions of ``api`` with leaf fields set by flat name."""
    o = api.ServeOptions()
    groups = o.flat_fields()
    for name, value in overrides.items():
        setattr(getattr(o, groups[name]), name, value)
    return o


# ---------------------------------------------------------------------
# options tree, defaults, parser
# ---------------------------------------------------------------------
def test_options_tree_equals_the_reference():
    assert papi.ServeOptions.flat_fields() == japi.ServeOptions.flat_fields()
    assert ([g for g, _ in papi.ServeOptions.groups()]
            == [g for g, _ in japi.ServeOptions.groups()])
    port, ref = papi.ServeOptions(), japi.ServeOptions()
    for name, group in papi.ServeOptions.flat_fields().items():
        got = getattr(getattr(port, group), name)
        want = getattr(getattr(ref, group), name)
        if name == "device_model":
            assert (want, got) == DEVICE_MODEL
        else:
            assert got == want, name


def test_effective_defaults_equal_but_the_renamed_engine():
    assert papi.EFFECTIVE_DEFAULTS.keys() == japi.EFFECTIVE_DEFAULTS.keys()
    for key, want in japi.EFFECTIVE_DEFAULTS.items():
        got = papi.EFFECTIVE_DEFAULTS[key]
        if key == "calibrated_engine":
            assert (want, got) == CALIBRATED_ENGINE
        else:
            assert got == want, key


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_equals_the_reference():
    port, ref = _actions(pserve_cli.build_parser()), _actions(
        j_build_parser())
    assert set(port) == set(ref) | {"device"}
    for dest, want in ref.items():
        got = port[dest]
        for attr in ("option_strings", "type", "choices", "nargs", "const",
                     "required", "metavar"):
            assert getattr(got, attr) == getattr(want, attr), (dest, attr)
        assert type(got) is type(want), dest
        if dest == "device_model":
            assert (want.default, got.default) == DEVICE_MODEL
        else:
            assert got.default == want.default, dest
    device = port["device"]
    assert device.option_strings == ["--device"]
    assert device.default == "cuda" and device.choices == ["cuda", "cpu"]


def test_from_args_roundtrip_and_parser_defaults_valid():
    args = pserve_cli.build_parser().parse_args(
        ["--requests", "5", "--rate", "3.5", "--kv-layout", "dense",
         "--slots", "6", "--stream", "--device", "cpu"])
    o = papi.ServeOptions.from_args(args)
    assert (o.workload.requests, o.workload.rate) == (5, 3.5)
    assert (o.engine.kv_layout, o.engine.slots, o.engine.stream) == (
        "dense", 6, True)
    o.validate()
    papi.ServeOptions.from_args(
        pserve_cli.build_parser().parse_args([])).validate()


# ---------------------------------------------------------------------
# validation: tests/test_api.py's cases, then both packages side by side
# ---------------------------------------------------------------------
@pytest.mark.parametrize("overrides,match", [
    ({"placement": "auto", "prefill_engine": "xla"}, "placement auto"),
    ({"stream": True, "static_batching": True}, "continuous engine"),
    ({"static_batching": True, "watchdog": True}, "static-batching"),
    ({"static_batching": True, "trace": "/tmp/t.json"}, "static-batching"),
    ({"static_batching": True, "sync_handoff": True,
      "placement": "disagg"}, "static-batching"),
    ({"prefix_sharing": True, "kv_layout": "dense"}, "paged"),
    ({"prefix_sharing": True, "static_batching": True}, "KV pool"),
    ({"shared_prefix_len": 0}, "shared-prefix-len"),
    ({"shared_frac": 0.5}, "shared-frac"),
    ({"misprice": 0.0, "watchdog": True}, "misprice"),
    ({"misprice_phase": "decode", "watchdog": True}, "misprice-phase"),
    ({"misprice": 2.0}, "watchdog"),
    ({"drift_gate": 1.2}, "watchdog"),
    ({"slo_ttft_ms": 100.0}, "slo-report"),
    ({"slo_tpot_ms": 10.0}, "slo-report"),
    ({"calibrated_engine": "xla"}, "calibrated-cache"),
    ({"sync_handoff": True}, "disagg"),
    ({"prefill_slots": 4}, "disagg"),
    ({"handoff_link_bw": 1e9}, "disagg"),
    ({"speculate": True, "static_batching": True}, "static-batching"),
    ({"speculate": True, "prefix_sharing": True}, "prefix-sharing"),
    ({"speculate": True, "kv_layout": "dense"}, "paged"),
    ({"draft_arch": "qwen2_1_5b"}, "speculate"),
    ({"draft_k": 2}, "speculate"),
    ({"speculate": True, "draft_k": 0}, "draft-k"),
])
def test_validate_raises(overrides, match):
    with pytest.raises(ValueError, match=match):
        _opts(papi, **overrides).validate()


def test_validate_accepts_consistent_options():
    _opts(papi, shared_prefix_len=16, shared_frac=0.5).validate()
    _opts(papi, watchdog=True, misprice=4.0,
          misprice_phase="decode").validate()
    _opts(papi, slo_report=True, slo_ttft_ms=100.0).validate()
    _opts(papi, placement="disagg", sync_handoff=True,
          prefill_slots=4).validate()
    _opts(papi, speculate=True, draft_arch="qwen2_1_5b",
          draft_k=2).validate()


# a few values per leaf, the field's default first
_CHOICES = {
    "shared_prefix_len": [None, 0, 16], "shared_frac": [None, 0.5],
    "static_batching": [False, True], "kv_layout": ["paged", "dense"],
    "prefix_sharing": [False, True], "stream": [False, True],
    "calibrated_cache": [None, "c.json"],
    "calibrated_engine": [None, "torch"],
    "placement": ["colocated", "disagg", "auto"],
    "prefill_engine": [None, "torch"], "decode_engine": [None, "torch"],
    "prefill_slots": [None, 4], "device_assignment": ["single", "auto"],
    "sync_handoff": [False, True], "handoff_link_bw": [None, 1e9],
    "measure_link_bw": [None, True], "trace": [None, "t.json"],
    "metrics_out": [None, "m.json"], "feed_cache": [None, True],
    "persist_curves": [None, "p.json"], "watchdog": [False, True],
    "drift_gate": [None, 1.2], "misprice": [None, 0.0, 2.0],
    "misprice_phase": [None, "decode"], "slo_report": [False, True],
    "slo_ttft_ms": [None, 100.0], "slo_tpot_ms": [None, 10.0],
    "speculate": [False, True], "draft_arch": [None, "qwen2_1_5b"],
    "draft_k": [None, 0, 2],
}


def _verdict(options):
    try:
        options.validate()
    except ValueError as err:
        return str(err)
    return "valid"


def test_validate_decides_as_the_reference_on_random_options():
    rng = np.random.default_rng(0)
    verdicts = set()
    for _ in range(400):
        # each leaf keeps its default with probability 0.8
        picked = {name: values[int(rng.integers(1, len(values)))]
                  for name, values in _CHOICES.items()
                  if rng.random() < 0.2}
        want = _verdict(_opts(japi, **picked))
        assert _verdict(_opts(papi, **picked)) == want, picked
        verdicts.add(want)
    assert "valid" in verdicts and len(verdicts) > 10


@pytest.mark.parametrize("overrides,item", [
    ({"placement": "disagg"}, "item 4"),
    ({"placement": "auto"}, "item 4"),
    ({"prefill_engine": "torch"}, "item 4"),
    ({"decode_engine": "torch"}, "item 4"),
    ({"device_assignment": "auto"}, "item 4"),
    ({"measure_link_bw": True}, "item 4"),
    ({"mesh": "pod"}, "item 9"),
    ({"mesh": "multipod"}, "item 9"),
    ({"speculate": True}, "item 5"),
    ({"watchdog": True}, "item 6"),
    ({"feed_cache": True}, "item 6"),
    ({"persist_curves": "curves.json"}, "item 6"),
])
def test_unported_options_raise_with_their_roadmap_item(overrides, item,
                                                       tmp_path, monkeypatch):
    """Options whose modules are not ported raise, naming their ROADMAP
    item.  The name is historical for the ``item 4``, ``item 5`` and
    ``item 6`` cases: placement, disaggregation, speculative decoding, the
    watchdog, telemetry feedback and persisted curves are ported, so those
    options now serve every request, with the colocated run's tokens
    (neither placement, speculation nor re-pricing changes a token;
    ``--speculate`` alone prices the default self-draft worse than plain
    decode and serves plain).  The ``item 6`` options serve on the
    disaggregated loop too (``--placement disagg``: item 6c, re-placement
    and live migration, is ported), with the colocated run's tokens."""
    options = _opts(papi, **overrides)
    options.validate()                       # valid, as in the JAX package
    if item not in ("item 4", "item 5", "item 6"):
        with pytest.raises(NotImplementedError, match=item):
            papi.serve(options, device="cpu")
        return
    monkeypatch.chdir(tmp_path)              # the caches these options write
    small = dict(requests=4, prompt_len=8, gen_len=8, rate=1e9, slots=3)
    report = papi.serve(_opts(papi, **small, **overrides), device="cpu")
    colocated = papi.serve(_opts(papi, **small), device="cpu")
    if item == "item 6":
        disagg = papi.serve(_opts(papi, **small, **overrides,
                                  placement="disagg"), device="cpu")
        assert disagg.outputs == colocated.outputs
        assert disagg.handoff["n_handoffs"] == small["requests"]
        assert disagg.decode_target == "decode"
    assert report.summary["requests_done"] == small["requests"]
    assert [len(report.outputs[r.rid]) for r in report.requests] == [
        r.max_new_tokens for r in report.requests]
    assert report.outputs == colocated.outputs
    if overrides.get("placement") == "disagg":
        assert report.handoff["n_handoffs"] == small["requests"]
        assert report.placement["mode"] == "disagg"
    if "measure_link_bw" in overrides:
        assert (tmp_path / "build" / "profile_cache_torch.json").exists()
    if overrides.get("speculate"):
        assert report.speculation["priced_fallback"] is True
        assert colocated.speculation is None
    if overrides.get("watchdog"):
        assert report.watchdog["config"]["drift_gate"] == 1.5
        assert colocated.watchdog is None
    if "feed_cache" in overrides:
        assert (tmp_path / "build" / "profile_cache_torch.json").exists()
    if "persist_curves" in overrides:
        assert (tmp_path / overrides["persist_curves"]).exists()


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papi.serve(papi.ServeOptions())


def test_serve_on_the_card_runs_the_paged_kernel(monkeypatch, weights):
    """On a CUDA device, serve() hands the engine a config whose paged
    attention is the kernel (the plain gather runs in tests only)."""
    seen = {}

    class Stop(Exception):
        pass

    def engine_loop(cfg, params, **kw):
        seen.update(impl=cfg.paged_attention_impl, device=kw["device"])
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(papi, "build_params", lambda cfg, dev: weights[1])
    monkeypatch.setattr(papi, "EngineLoop", engine_loop)
    with pytest.raises(Stop):
        papi.serve(_opts(papi, requests=1), device="cuda")
    assert seen == {"impl": "hopper", "device": torch.device("cuda")}


# ---------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------
def test_registry_resolves_the_ported_archs():
    """The name is historical only in that every arch is ported now: the
    two cross-attention archs resolve too, each to the JAX package's
    config field by field (tests/test_torch_cross.py)."""
    assert pregistry.ARCH_NAMES == jregistry.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in pregistry.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jregistry.SHAPES.items()}
    for name in ("qwen2_1_5b", "alexnet"):
        got, want = pregistry.get(name), jregistry.get(name)
        assert (got.name, got.family, got.lr_schedule) == (
            want.name, want.family, want.lr_schedule)
        for shape in pregistry.SHAPES:
            assert (pregistry.supports(got, shape)
                    == jregistry.supports(want, shape))
    assert pregistry.get("qwen2_1_5b").config == pcfgs.CONFIG
    assert pregistry.get("alexnet").config is None
    # every config is ported (tests/test_torch_families.py holds the
    # decoder-only ones, tests/test_torch_cross.py the cross-attention ones)
    assert pregistry.get("granite_34b").config.n_layers == 88
    assert set(pregistry.all_archs()) == set(pregistry.ARCH_NAMES)
    seamless = pregistry.get("seamless_m4t_medium")
    assert (seamless.config.enc_layers, seamless.config.encoder_decoder) \
        == (12, True)
    assert pregistry.get("llama32_vision_90b").config.img_seq == 6404
    with pytest.raises(ModuleNotFoundError):
        pregistry.get("no_such_arch")


# ---------------------------------------------------------------------
# serve() end to end, against the JAX package's
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
def float32_smoke(monkeypatch, weights):
    """Both packages serve the float32 SMOKE qwen2 on the same weights; the
    JAX package's static server takes the port's numpy prompts."""
    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=JCFG))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=PCFG))
    monkeypatch.setattr(japi, "build_params", lambda cfg, mesh: weights[0])
    monkeypatch.setattr(papi, "build_params", lambda cfg, dev: weights[1])
    rng = np.random.default_rng(1)           # the port's static prompts

    def randint(key, shape, lo, hi):
        return jnp.asarray(rng.integers(lo, hi, size=shape, dtype=np.int32))

    monkeypatch.setattr(jax.random, "randint", randint)


SERVE = dict(requests=6, prompt_len=6, gen_len=8, rate=1e9, slots=3)


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_serve_continuous_tokens_equal_the_reference(float32_smoke,
                                                     kv_layout):
    got = papi.serve(_opts(papi, kv_layout=kv_layout, **SERVE),
                     device="cpu")
    want = japi.serve(_opts(japi, kv_layout=kv_layout, **SERVE))
    assert got.summary["requests_done"] == SERVE["requests"]
    assert got.outputs == want.outputs
    assert [len(v) for v in got.outputs.values()] == [
        r.max_new_tokens for r in got.requests]
    assert got.pool_stats.keys() == want.pool_stats.keys()
    assert [a.keys() for a in got.admission] == [
        a.keys() for a in want.admission]


def test_serve_static_tokens_equal_the_reference(float32_smoke):
    opts = dict(SERVE, static_batching=True, batch=4)
    got = papi.serve(_opts(papi, **opts), device="cpu")
    want = japi.serve(_opts(japi, **opts))
    assert got.summary.keys() == want.summary.keys()
    assert got.summary["tokens"] == want.summary["tokens"]
    assert len(got.static_tokens) == len(want.static_tokens) == 2
    for g, w in zip(got.static_tokens, want.static_tokens):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_serve_trace_metrics_and_slo_outputs(float32_smoke, tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    deltas = []
    report = papi.serve(_opts(papi, trace=str(trace),
                              metrics_out=str(metrics), slo_report=True,
                              stream=True, **SERVE),
                        device="cpu", on_delta=deltas.append)
    checks = validate_trace(str(trace))
    assert all(ok for _, ok, _ in checks), checks
    snapshot = json.loads(metrics.read_text())
    assert snapshot["summary"]["requests_done"] == SERVE["requests"]
    assert snapshot["trace"]["n_open"] == 0
    assert [r["class"] for r in report.slo] == ["short", "medium", "long",
                                                "all"]
    assert report.slo[-1]["n"] == SERVE["requests"]
    streamed = {}
    for d in deltas:
        streamed.setdefault(d.rid, []).extend(d.tokens)
    assert streamed == report.outputs


def test_cli_serves_on_the_cpu_and_exits_on_bad_options(float32_smoke,
                                                        capsys):
    pserve_cli.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                     "4", "--gen-len", "4", "--rate", "1e9", "--slots", "2"])
    assert "requests_done: 2" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        pserve_cli.main(["--device", "cpu", "--shared-frac", "0.5"])
    assert exc.value.code == 2
    # --speculate and --watchdog are ported: they serve (--speculate here
    # priced worse than plain decode, so plain), --watchdog on the
    # disaggregated loop too; an unported flag (a pod mesh) exits naming its
    # ROADMAP item
    pserve_cli.main(["--device", "cpu", "--speculate", "--requests", "2",
                     "--prompt-len", "4", "--gen-len", "4", "--rate", "1e9",
                     "--slots", "2"])
    out = capsys.readouterr().out
    assert "requests_done: 2" in out
    assert "[serve] speculation: prices worse than plain decode" in out
    pserve_cli.main(["--device", "cpu", "--watchdog", "--requests", "2",
                     "--prompt-len", "4", "--gen-len", "4", "--rate", "1e9",
                     "--slots", "2"])
    out = capsys.readouterr().out
    assert "requests_done: 2" in out and "[serve] watchdog: " in out
    pserve_cli.main(["--device", "cpu", "--watchdog", "--placement",
                     "disagg", "--requests", "2", "--prompt-len", "4",
                     "--gen-len", "4", "--rate", "1e9", "--slots", "2"])
    out = capsys.readouterr().out
    assert "requests_done: 2" in out and "[serve] watchdog: " in out
    assert "[serve] decode target: decode engine" in out
    with pytest.raises(SystemExit, match="item 9"):
        pserve_cli.main(["--device", "cpu", "--mesh", "pod"])


# ---------------------------------------------------------------------
# obs: SLO rows and the trace export
# ---------------------------------------------------------------------
def _stamped_requests():
    rng = np.random.default_rng(7)
    reqs = []
    for rid in range(11):
        gen = int(rng.choice([2, 5, 9, 17]))
        r = Request(rid=rid, prompt=np.zeros(3, np.int32),
                    max_new_tokens=gen, arrival=float(rng.random()))
        if rid != 4:                         # one request never finishes
            r.t_first_token = r.arrival + float(rng.exponential(0.5))
            r.output = list(range(gen))
            r.t_done = r.t_first_token + gen * float(rng.exponential(0.05))
        reqs.append(r)
    return reqs


def test_slo_rows_equal_the_reference():
    reqs = _stamped_requests()
    for ttft, tpot in ((0.5, 0.05), (2.0, 0.2), (0.01, 0.001)):
        assert (slo_attainment(reqs, ttft_slo_s=ttft, tpot_slo_s=tpot)
                == j_slo_attainment(reqs, ttft_slo_s=ttft, tpot_slo_s=tpot))


def test_chrome_trace_equals_the_reference_export():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    tracer = Tracer(clock)
    h = tracer.begin("burst", track="engine:colocated", cat="engine",
                     args={"steps": np.int64(4), "bad": float("nan")})
    tracer.span("queued", 0.1, 0.3, track="requests", tid=2, cat="request")
    tracer.instant("done", track="requests", tid=2, cat="request")
    tracer.end(h)
    assert chrome_trace(tracer) == j_chrome_trace(tracer)
