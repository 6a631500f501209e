"""The watchdog's re-placement and live migration on the port's
disaggregated loop against the JAX package's, on the CPU.

* The JAX package's migration workload (tests/test_multidevice.py: 10
  requests, prompts 4-8, generations 12-16, 4 + 4 slots) with the decode
  device model priced 1e6x too fast, served by both packages' loops on one
  device under a ``PerfWatchdog`` and a virtual clock (so every burst's
  elapsed time, and with it every alert, is the same in both): the same
  re-price events, the same live migrations and hand-off ledger, the
  colocated loop's tokens.  At the default drift gate the prefill stream
  alerts too and moves the decode phase back (a round trip); at a gate of
  1e3 only the decode stream alerts and the decode phase stays on the
  prefill engine.
* ``_live_migrate("prefill")`` called at one fixed mid-run state in both:
  the slots moved, ``_fed_base`` and the ledger, exactly.
* A hybrid ("rec", "attn") config and a gated cross-attention config (each
  request's cross row its own): migrated slots carry their recurrent state
  and cross row, so the tokens equal the colocated run's.
* ``_actuate_placement``'s refusals and ``_replace_placement``'s advice
  equal the JAX package's dicts.
* Under telemetry feedback only decode-engine bursts feed it, and with the
  watchdog on every burst is synced.
* ``--misprice-phase`` scopes the injected error to one phase's device
  model, as the JAX package's ``serve()`` does.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from repro.configs import registry as jregistry
from repro.core import device_models as jdm
from repro.models import transformer as JT
from repro.obs import DriftAlert as JDriftAlert
from repro.obs import Observability as JObservability
from repro.obs import PerfWatchdog as JPerfWatchdog
from repro.serving import DisaggregatedEngineLoop as JDisagg
from repro.serving import synthetic_workload as j_workload
from repro.serving.placement import drift_scaled_device as j_drift
from repro.serving.speculative import SpecPlan as JSpecPlan
from repro_torch.configs import registry as pregistry
from repro_torch.core import device_models as pdm
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import (DriftAlert, Observability, PerfWatchdog,
                             TelemetryFeedback, Tracer)
from repro_torch.serving import EngineLoop, SpecPlan
from repro_torch.serving import api as papi
from repro_torch.serving.disagg import DisaggregatedEngineLoop
from repro_torch.serving.placement import drift_scaled_device
from repro_torch.serving.request import synthetic_workload

torch.set_num_threads(2)

_TINY = dict(name="md-tiny", n_layers=3, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab=64, attention_impl="dot")
JCFG = JT.ModelConfig(**_TINY, compute_dtype=jnp.float32, remat=False)
PCFG = PT.ModelConfig(**_TINY, compute_dtype=torch.float32)
MIG_LEN = 8 + 16
# the hosted pair both packages define: the decode board priced 1e6x too
# fast, so its stream drifts "slow" and re-placement moves decode off it
NAMES = dict(prefill_placement_engine_name="de5-roofline",
             decode_placement_engine_name="k40-roofline")
PAIR = dict(prefill_device=pdm.DE5_ROOFLINE,
            decode_device=drift_scaled_device(pdm.K40_ROOFLINE, 1e-6), **NAMES)
JPAIR = dict(prefill_device=jdm.DE5_ROOFLINE,
             decode_device=j_drift(jdm.K40_ROOFLINE, 1e-6), **NAMES)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   JCFG))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(PCFG, tree, device="cpu"))


def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _workload(fn):
    return fn(10, rate=1e9, vocab=JCFG.vocab, prompt_lens=(4, 8),
              gen_lens=(12, 16), seed=5)


def _outputs(reqs):
    return {r.rid: [int(t) for t in r.output] for r in reqs}


def _colocated(cfg, params, bind_hook=None):
    loop = EngineLoop(cfg, params, n_slots=4, max_seq=MIG_LEN, device="cpu")
    if bind_hook is not None:
        bind_hook(loop.engine)
    reqs = _workload(synthetic_workload)
    assert loop.run(reqs, now_fn=_clock()).n_done == 10
    return _outputs(reqs)


def _actuated(cfg, params, gate=None, bind_hook=None, **obs):
    watchdog = PerfWatchdog() if gate is None else PerfWatchdog(
        drift_gate=gate)
    loop = DisaggregatedEngineLoop(
        cfg, params, n_prefill_slots=4, n_decode_slots=4, max_seq=MIG_LEN,
        obs=Observability(watchdog=watchdog, **obs), device="cpu", **PAIR)
    if bind_hook is not None:
        bind_hook(loop.prefill)
    reqs = _workload(synthetic_workload)
    metrics = loop.run(reqs, now_fn=_clock())
    return loop, metrics, reqs


def _reprice_view(events):
    keys = ("engine", "phase", "ewma_ratio", "pricing", "token_budget_old",
            "token_budget", "placement_advice", "drifted_device", "actuated",
            "decode_target", "live_migrations", "reason")
    return [{k: e.get(k) for k in keys} for e in events]


# ---------------------------------------------- live migration, exact
@pytest.mark.parametrize("gate,target", [(None, "decode"), (1e3, "prefill")])
def test_live_migration_equals_colocated_and_the_reference(weights, gate,
                                                           target):
    colocated = _colocated(PCFG, weights[1])
    dis, m, reqs = _actuated(PCFG, weights[1], gate=gate)
    assert m.n_done == 10 and m.n_dropped == 0
    assert _outputs(reqs) == colocated
    jwd = JPerfWatchdog() if gate is None else JPerfWatchdog(drift_gate=gate)
    ref = JDisagg(JCFG, weights[0], n_prefill_slots=4, n_decode_slots=4,
                  max_seq=MIG_LEN, obs=JObservability(watchdog=jwd), **JPAIR)
    jreqs = _workload(j_workload)
    jm = ref.run(jreqs, now_fn=_clock())
    assert (jm.n_done, jm.n_dropped) == (10, 0)
    assert _outputs(jreqs) == colocated
    assert dis.decode_target == ref.decode_target == target
    assert dis.handoff.n_live_migrations >= 1
    assert dis.handoff.stats() == ref.handoff.stats()
    got = _reprice_view(dis.obs.watchdog.reprices)
    assert got == _reprice_view(ref.obs.watchdog.reprices)
    # the decode stream's alert actuates first: decode moves onto the
    # prefill engine, taking in-flight slots with it
    assert got[0]["phase"] == "decode" and got[0]["actuated"] is True
    assert got[0]["decode_target"] == "prefill"
    assert got[0]["live_migrations"] >= 1
    assert len(got) == (1 if gate else 2)
    # both pools drained; no migrated request is left with a fed base
    assert dis._fed_base == {}
    assert dis.prefill.pool.free_slot_count == 4
    assert dis.decode.pool.free_block_count == dis.decode.pool.total_blocks


def test_live_migrate_at_a_fixed_state_equals_the_reference(weights):
    """Both loops stopped after the same steps, then the decode phase's
    in-flight slots moved onto the prefill engine by hand."""
    dis = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=4,
                                  n_decode_slots=4, max_seq=MIG_LEN,
                                  device="cpu", **PAIR)
    ref = JDisagg(JCFG, weights[0], n_prefill_slots=4, n_decode_slots=4,
                  max_seq=MIG_LEN, **JPAIR)
    dis.run(_workload(synthetic_workload), now_fn=_clock(), max_steps=40)
    ref.run(_workload(j_workload), now_fn=_clock(), max_steps=40)
    before = dis.handoff.stats()
    live = [(s, r.rid) for s, r in enumerate(dis.decode.slots)
            if r is not None]
    assert live == [(s, r.rid) for s, r in enumerate(ref.decode.slots)
                    if r is not None]
    moved = dis._live_migrate("prefill")
    assert moved == ref._live_migrate("prefill") >= 1
    assert dis._fed_base == ref._fed_base and len(dis._fed_base) == moved
    assert dis.handoff.stats() == ref.handoff.stats()
    assert dis.handoff.n_live_migrations == moved
    assert dis.handoff.bytes_moved > before["bytes_moved"]
    assert [r and r.rid for r in dis.prefill.slots] == [
        r and r.rid for r in ref.prefill.slots]
    assert (dis.prefill.steps_total.tolist()
            == np.asarray(ref.prefill.steps_total).tolist())


# ---------------------------------------------- what a slot carries
def _cross_rows(cfg, n):
    return torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, cfg.img_seq, cfg.d_model)).astype(np.float32))


def _write_cross_row_at_bind(rows, eng):
    """Each request's cross row is its own (``rows[rid]``), written into
    its slot when it is bound, so a slot that moves must take it along."""
    bind = eng.bind

    def bound(req, **kw):
        bind(req, **kw)
        eng.cache["cross"][req.slot] = rows[req.rid]

    eng.bind = bound


@pytest.mark.parametrize("kind", ["hybrid", "cross"])
def test_migrated_slots_carry_recurrent_state_and_cross_rows(kind):
    if kind == "hybrid":
        cfg = dataclasses.replace(PCFG, block_pattern=("rec", "attn"))
        hook = None
    else:
        cfg = dataclasses.replace(PCFG, cross_attn_every=2,
                                  frontend="vision", img_seq=4)
        hook = functools.partial(_write_cross_row_at_bind,
                                 _cross_rows(cfg, 10))
    # nonzero gates, so the cross branch counts
    params = PT.map_params(
        lambda name, t: torch.ones_like(t) if name.startswith("gate_")
        else t, PT.init_params(cfg, 0, device="cpu"))
    colocated = _colocated(cfg, params, bind_hook=hook)
    dis, m, reqs = _actuated(cfg, params, gate=1e3, bind_hook=hook)
    assert m.n_done == 10 and m.n_dropped == 0
    assert dis.handoff.n_live_migrations >= 1
    assert dis.decode_target == "prefill"
    assert _outputs(reqs) == colocated
    if kind == "cross":
        # a different row changes the tokens: the comparison can see one
        # that did not move with its slot
        rows = _cross_rows(cfg, 10)
        other = _colocated(cfg, params, bind_hook=functools.partial(
            _write_cross_row_at_bind, rows.flip(0)))
        assert other != colocated


# ---------------------------------------------- actuation, exact
def test_actuation_refusals_equal_the_reference(weights):
    spec = DisaggregatedEngineLoop(
        PCFG, weights[1], n_prefill_slots=2, n_decode_slots=2, max_seq=16,
        plan=SpecPlan(draft_cfg=PCFG, draft_params=weights[1], k=2),
        device="cpu", **NAMES)
    jspec = JDisagg(JCFG, weights[0], n_prefill_slots=2, n_decode_slots=2,
                    max_seq=16, plan=JSpecPlan(draft_cfg=JCFG,
                                               draft_params=weights[0], k=2),
                    **NAMES)
    got = spec._actuate_placement(decision=None)
    assert got == jspec._actuate_placement(decision=None) == {
        "actuated": False,
        "reason": "speculative decoding pins the decode engine"}
    single = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=2,
                                     n_decode_slots=2, max_seq=16,
                                     device="cpu")
    jsingle = JDisagg(JCFG, weights[0], n_prefill_slots=2, n_decode_slots=2,
                      max_seq=16)
    got = single._actuate_placement(decision=None)
    assert got == jsingle._actuate_placement(decision=None) == {
        "actuated": False, "reason": "single-engine placement"}
    hosted = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=2,
                                     n_decode_slots=2, max_seq=16,
                                     device="cpu", **NAMES)
    jhosted = JDisagg(JCFG, weights[0], n_prefill_slots=2, n_decode_slots=2,
                      max_seq=16, **NAMES)
    for engine in ("torch", "k40-roofline"):
        decision = types.SimpleNamespace(decode_engine=engine)
        assert (hosted._actuate_placement(decision)
                == jhosted._actuate_placement(decision))
    assert hosted._actuate_placement(types.SimpleNamespace(
        decode_engine="torch"))["reason"] == \
        "decode engine 'torch' is not hosted"
    assert hosted.decode_target == "decode"


@pytest.mark.parametrize("phase,ratio", [("decode", 40.0), ("decode", 0.02),
                                         ("prefill", 7.5)])
def test_replacement_advice_equals_the_reference(weights, phase, ratio):
    def alert(cls):
        return cls(engine=phase, phase=phase, t=0.0, ewma_ratio=ratio,
                   priced_step_s=1e-3, observed_step_s=ratio * 1e-3,
                   n_obs=4, batch=2,
                   direction="slow" if ratio > 1 else "fast")

    kw = dict(n_prefill_slots=2, n_decode_slots=3, max_seq=MIG_LEN)
    for names in ({}, NAMES):
        dis = DisaggregatedEngineLoop(
            PCFG, weights[1], device="cpu", prefill_device=pdm.DE5_ROOFLINE,
            decode_device=pdm.K40_ROOFLINE, **kw, **names)
        ref = JDisagg(JCFG, weights[0], prefill_device=jdm.DE5_ROOFLINE,
                      decode_device=jdm.K40_ROOFLINE, **kw, **names)
        got = dis._replace_placement(alert(DriftAlert))
        want = ref._replace_placement(alert(JDriftAlert))
        if not names:
            # one shared name: the port's default engine is "torch" on the
            # H100 model, the JAX package's "xla" on a TPU; advice only
            assert got["actuated"] is want["actuated"] is False
            assert got["reason"] == want["reason"]
            assert got["placement_advice"] is not None
            continue
        assert got == want
        assert got["placement_advice"]["prefill_engine"] in (
            "de5-roofline", "k40-roofline")
        assert dis.decode_target == ref.decode_target


# ---------------------------------------------- synced timing
@pytest.mark.parametrize("watched", [False, True])
def test_only_decode_bursts_feed_and_watched_bursts_sync(weights, watched):
    tracer = Tracer()
    feedback = TelemetryFeedback(PCFG, kv_len=MIG_LEN, device="cpu",
                                 dtype="float32")
    dis = DisaggregatedEngineLoop(
        PCFG, weights[1], n_prefill_slots=4, n_decode_slots=4,
        max_seq=MIG_LEN, device="cpu",
        obs=Observability(tracer=tracer, feedback=feedback,
                          watchdog=PerfWatchdog() if watched else None))
    reqs = _workload(synthetic_workload)
    assert dis.run(reqs, now_fn=_clock()).n_done == 10
    bursts = tracer.spans("burst")
    on = {name: tracer.track(f"engine:{name}")
          for name in ("prefill", "decode")}
    decode = [e for e in bursts if e.pid == on["decode"]]
    prefill = [e for e in bursts if e.pid == on["prefill"]]
    assert len(decode) + len(prefill) == len(bursts)
    assert feedback.n_bursts == len(decode) > 0 and prefill
    assert all(e.args["synced"] for e in decode)
    assert all(e.args["synced"] is watched for e in prefill)
    assert _outputs(reqs) == _colocated(PCFG, weights[1])


# ---------------------------------------------- --misprice-phase
@pytest.fixture
def captured_loops(monkeypatch, weights):
    """Both packages' serve() build their disaggregated loop on the TINY
    float32 weights and stop right after it is built."""

    class Built(Exception):
        pass

    loops = []

    def capture(cls):
        class Capture(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                loops.append(self)
                raise Built

        return Capture

    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=JCFG))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=PCFG))
    monkeypatch.setattr(japi, "build_params", lambda cfg, mesh: weights[0])
    monkeypatch.setattr(papi, "build_params", lambda cfg, dev: weights[1])
    monkeypatch.setattr(japi, "DisaggregatedEngineLoop", capture(JDisagg))
    monkeypatch.setattr(papi, "DisaggregatedEngineLoop",
                        capture(DisaggregatedEngineLoop))

    def build(api, **fields):
        options = api.ServeOptions()
        groups = options.flat_fields()
        for name, value in fields.items():
            setattr(getattr(options, groups[name]), name, value)
        kw = {"device": "cpu"} if api is papi else {}
        with pytest.raises(Built):
            api.serve(options, **kw)
        return loops.pop()

    return build


@pytest.mark.parametrize("phase", ["decode", "prefill", "both", None])
def test_misprice_phase_scopes_one_phase_as_the_reference(captured_loops,
                                                          phase):
    fields = dict(placement="disagg", prefill_engine="k40-roofline",
                  decode_engine="de5-roofline", watchdog=True,
                  misprice=250.0, misprice_phase=phase, slots=3,
                  prompt_len=8, gen_len=8)
    got = captured_loops(papi, **fields)
    want = captured_loops(japi, **fields)
    scaled = {"decode", "prefill"} if phase in ("both", None) else {phase}
    for b, jb in zip(got.batchers, want.batchers):
        assert b.phase == jb.phase
        assert b.device_name == jb.device_name
        assert b.device_name.endswith("-drift250x") == (b.phase in scaled)
        for n in (1, 3):
            assert b.priced_step_s(n) == jb.priced_step_s(n)
    assert (got._prefill_placement_name, got._decode_placement_name) == (
        want._prefill_placement_name, want._decode_placement_name) == (
        "k40-roofline", "de5-roofline")
