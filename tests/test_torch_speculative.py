"""The port's speculative decoding against the JAX package's, on the CPU, at
tests/test_speculative.py's sizes (TGT 3 layers / d_model 32, DRAFT 2 / 24,
vocab 64, float32, 4 slots, max_seq 32, pages of 8).

* ``decode_multi_step_slots_paged`` equals sequential
  ``decode_step_slots_paged`` bit for bit inside the port, keeps every cache
  tensor's storage, leaves ``pos`` alone without ``advance``, and equals the
  JAX package's multi step within tests/test_kernels.py's fp32 tolerance.
* ``SpeculativeEngineLoop`` and the disaggregated loop's speculating decode
  engine give the port's plain tokens bit for bit, and the JAX package's;
  a self-draft accepts everything, forced rejections give the JAX package's
  round tallies, rollback returns every page, the verify and the draft write
  their buffers in place, and a mid-run veto keeps the tokens.
* ``choose_speculation``, ``AcceptanceTracker``, ``validate_speculation``
  and the acceptance cache equal or mirror the JAX package's.
* ``serve(..., device="cpu")`` with ``--speculate --draft-k 2`` gives the
  plain run's and the JAX package's tokens; ``--speculate`` alone falls
  back to plain with the JAX package's decision.

The JAX side runs on its ``xla``/``ref`` paths; weights go through
``params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from repro.configs import qwen2_1_5b as jqwen
from repro.configs import registry as jregistry
from repro.core import device_models as jdm
from repro.models import transformer as JT
from repro.obs.watchdog import AcceptanceTracker as JTracker
from repro.profiling.acceptance import acceptance_measurement as j_measure
from repro.serving import DisaggregatedEngineLoop as JDisagg
from repro.serving import EngineLoop as JLoop
from repro.serving import SpecPlan as JPlan
from repro.serving import SpeculativeEngineLoop as JSpecLoop
from repro.serving import choose_speculation as j_choose
from repro.serving import synthetic_workload as j_workload
from repro.serving import validate_speculation as j_validate
from repro.serving.placement import drift_scaled_device as j_drift
from repro_torch.configs import qwen2_1_5b as pqwen
from repro_torch.configs import registry as pregistry
from repro_torch.core import device_models as pdm
from repro_torch.launch import serve as pserve_cli
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import AcceptanceTracker
from repro_torch.profiling import (ProfileCache, acceptance_measurement,
                                   cached_acceptance, record_acceptance,
                                   validate_dict)
from repro_torch.serving import (DisaggregatedEngineLoop, EngineLoop,
                                 SpecPlan, SpeculativeEngineLoop,
                                 choose_speculation, synthetic_workload,
                                 validate_speculation)
from repro_torch.serving import api as papi
from repro_torch.serving.placement import drift_scaled_device

torch.set_num_threads(2)

_TGT = dict(name="spec-tgt", n_layers=3, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64, attention_impl="dot")
_DRAFT = dict(name="spec-draft", n_layers=2, d_model=24, n_heads=4,
              n_kv_heads=2, d_ff=48, vocab=64, attention_impl="dot")
JTGT = JT.ModelConfig(**_TGT, compute_dtype=jnp.float32, remat=False)
JDRAFT = JT.ModelConfig(**_DRAFT, compute_dtype=jnp.float32, remat=False)
TGT = PT.ModelConfig(**_TGT, compute_dtype=torch.float32)
DRAFT = PT.ModelConfig(**_DRAFT, compute_dtype=torch.float32)
LOOP = dict(n_slots=4, max_seq=32, block_size=8, kv_layout="paged")
# the device models both packages define
DEVICE_NAMES = ("tpu-v5e", "nvidia-k40", "k40-cublas", "k40-cudnn",
                "altera-de5", "nvidia-k40-roofline", "altera-de5-roofline")


@pytest.fixture(scope="module")
def weights():
    """(JAX target, JAX draft, port target, port draft) parameters, the
    reference's init from PRNGKey 0 and 7."""
    jt = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JTGT))
    jd = jax.tree.map(np.asarray,
                      JT.init_params(jax.random.PRNGKey(7), JDRAFT))
    return (jax.tree.map(jnp.asarray, jt), jax.tree.map(jnp.asarray, jd),
            params_from_numpy(TGT, jt, device="cpu"),
            params_from_numpy(DRAFT, jd, device="cpu"))


def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _workload(make, seed=3, rate=1e9):
    return make(9, rate=rate, vocab=64, prompt_lens=(5, 9),
                gen_lens=(4, 7, 13), seed=seed)


def _outputs(reqs):
    return {r.rid: [int(t) for t in r.output] for r in reqs}


def _run(params, *, plan=None, override=None):
    """The port's colocated loop, speculating with ``plan``."""
    reqs = _workload(synthetic_workload)
    if plan is None:
        loop = EngineLoop(TGT, params, device="cpu", **LOOP)
    else:
        loop = SpeculativeEngineLoop(TGT, params, plan=plan,
                                     propose_override=override,
                                     device="cpu", **LOOP)
    loop.run(reqs, now_fn=_clock())
    return _outputs(reqs), loop


def _run_ref(params, *, plan=None, override=None):
    """The JAX package's colocated loop, speculating with ``plan``."""
    reqs = _workload(j_workload)
    if plan is None:
        loop = JLoop(JTGT, params, **LOOP)
    else:
        loop = JSpecLoop(JTGT, params, plan=plan, propose_override=override,
                         **LOOP)
    loop.run(reqs, now_fn=_clock())
    return _outputs(reqs), loop


@pytest.fixture(scope="module")
def plain_outputs(weights):
    return _run(weights[2])[0]


@pytest.fixture(scope="module")
def ref_plain_outputs(weights):
    return _run_ref(weights[0])[0]


def test_plain_runs_of_both_packages_agree(plain_outputs, ref_plain_outputs):
    assert plain_outputs == ref_plain_outputs


# ---------------------------------------------------------------------
# the multi-token step
# ---------------------------------------------------------------------
B, MAX, BSZ, M = 3, 24, 8, 4
ACTIVE = np.array([True, True, False])


def _tokens():
    return np.random.default_rng(0).integers(0, 64, size=(B, 12)).astype(
        np.int32)


def _fresh(pkg):
    if pkg is JT:
        c = dict(JT.init_slot_cache_paged(JTGT, B, MAX, block_size=BSZ))
        bps = c["block_tables"].shape[1]
        c["block_tables"] = jnp.asarray(
            np.arange(B * bps, dtype=np.int32).reshape(B, bps))
        return c
    c = PT.init_slot_cache_paged(TGT, B, MAX, block_size=BSZ, device="cpu")
    bps = c["block_tables"].shape[1]
    c["block_tables"].copy_(torch.arange(B * bps, dtype=torch.int32)
                            .reshape(B, bps))
    return c


def _port_prefix(params, toks):
    """A paged cache after 5 single steps of ``toks``."""
    cache = _fresh(PT)
    active = torch.from_numpy(ACTIVE)
    for i in range(5):
        PT.decode_step_slots_paged(params, TGT, cache,
                                   torch.from_numpy(toks[:, i:i + 1]),
                                   active, max_seq=MAX)
    return cache


def _storage(cache):
    return [cache["pos"].data_ptr(), cache["block_tables"].data_ptr()] + [
        a.data_ptr() for layer in cache["layers"] for a in layer.values()]


@torch.no_grad()
def test_multi_step_bitwise_equals_sequential(weights):
    params, toks = weights[2], _tokens()
    active = torch.from_numpy(ACTIVE)
    seq, multi = _port_prefix(params, toks), _port_prefix(params, toks)
    singles = []
    for i in range(5, 5 + M):
        lg, _ = PT.decode_step_slots_paged(
            params, TGT, seq, torch.from_numpy(toks[:, i:i + 1]), active,
            max_seq=MAX)
        singles.append(lg[:, 0])
    logits, out = PT.decode_multi_step_slots_paged(
        params, TGT, multi, torch.from_numpy(toks[:, 5:5 + M]), active,
        max_seq=MAX, advance=True)
    assert out is multi
    assert torch.equal(logits, torch.stack(singles, dim=1))
    assert torch.equal(seq["pos"], multi["pos"])
    # every live page too (the trash page, the last, takes inactive writes)
    for a, b in zip(seq["layers"], multi["layers"]):
        for name in ("k", "v"):
            assert torch.equal(a[name][:-1], b[name][:-1])


@torch.no_grad()
def test_multi_step_equals_the_reference(weights):
    toks = _tokens()
    jc = _fresh(JT)
    for i in range(5):
        _, jc = JT.decode_step_slots_paged(
            weights[0], JTGT, jc, jnp.asarray(toks[:, i:i + 1]),
            jnp.asarray(ACTIVE), max_seq=MAX)
    want, jc = JT.decode_multi_step_slots_paged(
        weights[0], JTGT, jc, jnp.asarray(toks[:, 5:5 + M]),
        jnp.asarray(ACTIVE), max_seq=MAX, advance=True)
    cache = _port_prefix(weights[2], toks)
    got, _ = PT.decode_multi_step_slots_paged(
        weights[2], TGT, cache, torch.from_numpy(toks[:, 5:5 + M]),
        torch.from_numpy(ACTIVE), max_seq=MAX, advance=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jc["pos"]))


@pytest.mark.parametrize("advance", [True, False])
@torch.no_grad()
def test_multi_step_writes_in_place(weights, advance):
    """Every cache tensor keeps its storage (the engine's CUDA graphs read
    these addresses); ``advance=False`` leaves the positions alone."""
    cache = _port_prefix(weights[2], _tokens())
    before, pos0 = _storage(cache), cache["pos"].clone()
    PT.decode_multi_step_slots_paged(
        weights[2], TGT, cache, torch.from_numpy(_tokens()[:, 5:5 + M]),
        torch.from_numpy(ACTIVE), max_seq=MAX, advance=advance)
    assert _storage(cache) == before
    want = pos0 + torch.from_numpy(ACTIVE).int() * M if advance else pos0
    assert torch.equal(cache["pos"], want)


def test_multi_step_rejects_non_attention():
    hybrid = dict(_TGT, block_pattern=("attn", "rec"))
    with pytest.raises(ValueError) as want:
        JT.decode_multi_step_slots_paged(
            None, JT.ModelConfig(**hybrid, remat=False), {}, None, None,
            max_seq=8)
    with pytest.raises(ValueError) as got:
        PT.decode_multi_step_slots_paged(None, PT.ModelConfig(**hybrid), {},
                                         None, None, max_seq=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("b, m", [(8, 2), (8, 3), (32, 3)])
@torch.no_grad()
def test_multi_attention_offsets_equal_single_steps(b, m):
    """Each window offset of the verify's attention is the single-token
    attention at ``pos + i`` bit for bit: the offsets are contracted in the
    plain step's shapes, so the card rounds them as it rounds a step.  The
    verify's norms likewise (``rmsnorm_multi``)."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import rmsnorm

    rng = np.random.default_rng(b * 10 + m)
    hq, hk, t, d = 12, 2, 40, 16
    q = torch.from_numpy(rng.standard_normal((b, hq, m, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hk, t, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hk, t, d), np.float32))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    pos = torch.from_numpy(rng.integers(0, t - m + 1, b).astype(np.int32))
    out = attn_lib.decode_attention_multi(q, k, v, pos=pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    for i in range(m):
        one = attn_lib.decode_attention(q[:, :, i:i + 1], k, v, pos=pos + i)
        assert torch.equal(out[:, :, i:i + 1], one), i
    # the catch-up's batched form: the same numbers on the CPU
    assert torch.equal(attn_lib.decode_attention_multi(q, k, v, pos=pos,
                                                       stepwise=False), out)
    x = torch.from_numpy(rng.standard_normal((b, m, 48), np.float32))
    w = torch.from_numpy(rng.standard_normal(48, np.float32))
    normed = PT.rmsnorm_multi(x.bfloat16(), w)
    for i in range(m):
        assert torch.equal(normed[:, i:i + 1],
                           rmsnorm(x[:, i:i + 1].bfloat16(), w)), i


# ---------------------------------------------------------------------
# serving: speculative == plain, colocated
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_colocated_identity_all_depths(weights, plain_outputs,
                                       ref_plain_outputs, k):
    outs, loop = _run(weights[2], plan=SpecPlan(DRAFT, weights[3], k=k))
    assert outs == plain_outputs == ref_plain_outputs
    st = loop.spec.stats()
    assert st["n_rounds"] > 0, "speculation never engaged"
    assert st["n_committed"] >= st["n_rounds"]


def test_colocated_tokens_equal_the_reference_spec_loop(weights,
                                                        plain_outputs):
    want, jloop = _run_ref(weights[0], plan=JPlan(JDRAFT, weights[1], k=2))
    outs, loop = _run(weights[2], plan=SpecPlan(DRAFT, weights[3], k=2))
    assert outs == want == plain_outputs
    assert loop.spec.n_rounds == jloop.spec.n_rounds
    assert loop.spec.n_proposed == jloop.spec.n_proposed


def test_self_draft_full_acceptance(weights, plain_outputs):
    outs, loop = _run(weights[2], plan=SpecPlan(TGT, weights[2], k=3))
    assert outs == plain_outputs
    assert loop.spec.acceptance_rate == 1.0
    # a self-draft shares the target engine's weights
    assert loop.spec.draft.params["embed"] is loop.engine.params["embed"]


def _corrupt(offset):
    def override(round_index, proposals):
        p = proposals.copy()
        if offset < p.shape[1]:
            p[:, offset] = (p[:, offset] + 1) % 64
        return p

    return override


TALLIES = ("n_rounds", "n_proposed", "n_accepted", "n_committed")
OFFSETS = (0, 1, 3)


@pytest.fixture(scope="module")
def ref_rejection_tallies(weights):
    """The JAX package's round tallies with the self-draft (k 4) corrupted
    at each offset: one loop, run once per offset, so its steps compile
    once."""
    loop = JSpecLoop(JTGT, weights[0], plan=JPlan(JTGT, weights[0], k=4),
                     **LOOP)
    tallies = {}
    for offset in OFFSETS:
        for t in TALLIES:
            setattr(loop.spec, t, 0)
        loop.spec.propose_override = _corrupt(offset)
        loop.run(_workload(j_workload), now_fn=_clock())
        tallies[offset] = {t: getattr(loop.spec, t) for t in TALLIES}
    return tallies


@pytest.mark.parametrize("offset", OFFSETS)
def test_rejection_at_window_offset(weights, plain_outputs,
                                    ref_rejection_tallies, offset):
    """The self-draft's proposal corrupted at one window offset: rejection
    lands there every round, the tokens stay, and the round tallies equal
    the JAX package's."""
    outs, loop = _run(weights[2], plan=SpecPlan(TGT, weights[2], k=4),
                      override=_corrupt(offset))
    assert outs == plain_outputs
    assert loop.spec.acceptance_rate == pytest.approx(offset / 4)
    assert ({t: getattr(loop.spec, t) for t in TALLIES}
            == ref_rejection_tallies[offset])


def test_rollback_conserves_paged_pool(weights):
    _, loop = _run(weights[2], plan=SpecPlan(DRAFT, weights[3], k=3))
    stats = loop.pool.stats()
    assert stats["slots_in_use"] == 0
    assert stats["blocks_in_use"] == 0
    assert stats["peak_slots_in_use"] > 0


def test_verify_and_draft_write_their_buffers_in_place(weights,
                                                       plain_outputs):
    """The target engine's cache, chain head and output buffer, and the
    draft's cache, keep their storage through a speculative run: on a card
    the engine's step graph and the round's graphs replay on them."""
    reqs = _workload(synthetic_workload)
    loop = SpeculativeEngineLoop(TGT, weights[2],
                                 plan=SpecPlan(DRAFT, weights[3], k=2),
                                 device="cpu", **LOOP)
    eng, draft = loop.engine, loop.spec.draft

    def storage():
        return (_storage(eng.cache) + _storage(draft.cache)
                + [t.data_ptr() for t in (eng._last_tok, eng._out_buf,
                                          eng._plens, eng._prompts)])

    before = storage()
    loop.run(reqs, now_fn=_clock())
    assert _outputs(reqs) == plain_outputs
    assert loop.spec.n_rounds > 0
    assert storage() == before


def test_midrun_veto_keeps_outputs_identical(weights, plain_outputs):
    class _Veto:
        use = False

    tracker = AcceptanceTracker(warmup=2, redecide_every=2,
                                decide=lambda alpha: _Veto())
    outs, loop = _run(weights[2], plan=SpecPlan(DRAFT, weights[3], k=2,
                                                tracker=tracker))
    assert outs == plain_outputs
    assert loop.spec.disabled_midrun and not loop.spec.enabled
    assert loop.batcher.price_source == "speculation-disabled"
    assert loop.batcher.n_reprices == 1


# ---------------------------------------------------------------------
# disaggregated: speculation on the decode engine, hand-offs in flight
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k,rate", [(1, 1e9), (2, 1e9), (2, 700.0),
                                    (3, 700.0)])
def test_disagg_identity_with_handoffs(weights, plain_outputs, k, rate):
    reqs = _workload(synthetic_workload, rate=rate)
    loop = DisaggregatedEngineLoop(
        TGT, weights[2], n_prefill_slots=4, n_decode_slots=4, max_seq=32,
        block_size=8, plan=SpecPlan(DRAFT, weights[3], k=k), device="cpu")
    loop.run(reqs, now_fn=_clock())
    assert _outputs(reqs) == plain_outputs
    assert loop.spec.stats()["n_rounds"] > 0
    assert loop.handoff.n_handoffs == len(reqs)
    assert loop.decode.pool.stats()["blocks_in_use"] == 0


def test_disagg_tokens_equal_the_reference_spec_loop(weights):
    def run(loop_cls, cfg, params, plan, make, **kw):
        reqs = _workload(make, rate=700.0)
        loop = loop_cls(cfg, params, n_prefill_slots=4, n_decode_slots=4,
                        max_seq=32, block_size=8, plan=plan, **kw)
        loop.run(reqs, now_fn=_clock())
        return _outputs(reqs), loop

    want, jloop = run(JDisagg, JTGT, weights[0], JPlan(JDRAFT, weights[1],
                                                       k=2), j_workload)
    got, loop = run(DisaggregatedEngineLoop, TGT, weights[2],
                    SpecPlan(DRAFT, weights[3], k=2), synthetic_workload,
                    device="cpu")
    assert got == want
    assert loop.handoff.n_handoffs == jloop.handoff.n_handoffs
    assert loop.spec.n_rounds == jloop.spec.n_rounds


# ---------------------------------------------------------------------
# pricing, the acceptance tracker, the acceptance cache, validation
# ---------------------------------------------------------------------
def _pairs():
    return [((TGT, DRAFT), (JTGT, JDRAFT)),
            ((pqwen.CONFIG, pqwen.SMOKE), (jqwen.CONFIG, jqwen.SMOKE)),
            ((pqwen.CONFIG, pqwen.CONFIG), (jqwen.CONFIG, jqwen.CONFIG))]


@pytest.mark.parametrize("device_name", DEVICE_NAMES)
def test_choose_speculation_equals_the_reference(device_name):
    for (pt, pd), (jt, jd) in _pairs():
        for acceptance in (0.0, 0.5, 0.8, 0.95, 1.0):
            for kv_len, n_tokens in ((64, 8), (1024, 4)):
                kw = dict(kv_len=kv_len, n_tokens=n_tokens,
                          acceptance=acceptance, device_name=device_name,
                          draft_name="d")
                got, want = choose_speculation(pt, pd, **kw), j_choose(
                    jt, jd, **kw)
                assert got.summary() == want.summary()
                assert got.projected_speedup == want.projected_speedup
    # a draft priced on a 100x slower device: a fall-back
    kw = dict(kv_len=1024, n_tokens=8, acceptance=0.95)
    (pt, pd), (jt, jd) = _pairs()[2]
    got = choose_speculation(pt, pd, device_name=device_name,
                             draft_device=drift_scaled_device(
                                 pdm.get(device_name), 100.0), **kw)
    want = j_choose(jt, jd, device_name=device_name,
                    draft_device=j_drift(jdm.get(device_name), 100.0), **kw)
    assert got.summary() == want.summary() and not got.use


def test_acceptance_tracker_equals_the_reference():
    rng = np.random.default_rng(5)
    rounds = [(int(p), int(rng.integers(0, p + 1)))
              for p in rng.integers(0, 9, size=40)]

    def tracker(cls, choose, tgt, draft):
        return cls(warmup=3, redecide_every=4, decide=lambda alpha: choose(
            tgt, draft, kv_len=64, n_tokens=8, acceptance=alpha,
            device_name="tpu-v5e"))

    got = tracker(AcceptanceTracker, choose_speculation, TGT, DRAFT)
    want = tracker(JTracker, j_choose, JTGT, JDRAFT)
    for proposed, accepted in rounds:
        got.observe_round(proposed, accepted)
        want.observe_round(proposed, accepted)
    assert got.report() == want.report()
    assert got.acceptance == want.acceptance
    assert got.report()["decisions"], "the tracker never re-decided"


def test_acceptance_cache_roundtrip(tmp_path):
    cache = ProfileCache(device="cpu")
    # one entry per depth (the spec hashes k); each depth's tally replaces
    # the last
    for k, n_proposed, n_accepted in ((1, 40, 30), (2, 400, 100),
                                      (3, 10, 10)):
        record_acceptance(cache, draft_arch="qwen2_1_5b",
                          target_arch="qwen2_1_5b", k=k,
                          n_proposed=n_proposed, n_accepted=n_accepted,
                          n_rounds=n_proposed // k)
    assert len(cache) == 3
    path = cache.save(str(tmp_path / "cache.json"))
    loaded = ProfileCache.load(path, device="cpu")
    # the largest-sample measurement wins; another pair has none
    assert cached_acceptance(loaded, draft_arch="qwen2_1_5b",
                             target_arch="qwen2_1_5b") == 0.25
    assert cached_acceptance(loaded, draft_arch="other",
                             target_arch="qwen2_1_5b") is None
    assert validate_dict({"schema": 1, "entries": loaded.entries}) == []
    got = acceptance_measurement(draft_arch="a", target_arch="b", k=3,
                                 n_proposed=9, n_accepted=3, n_rounds=3,
                                 device="cpu")
    want = j_measure(draft_arch="a", target_arch="b", k=3, n_proposed=9,
                     n_accepted=3, n_rounds=3)
    env = {"jax_version", "backend", "torch_version", "device_name",
           "capability"}
    assert ({k: v for k, v in got.items() if k not in env | {"fingerprint"}}
            == {k: v for k, v in want.items()
                if k not in env | {"fingerprint"}})
    with pytest.raises(ValueError):
        acceptance_measurement(draft_arch="a", target_arch="b", k=1,
                               n_proposed=0, n_accepted=0, n_rounds=0,
                               device="cpu")


def _hybrid(pkg):
    fields = dict(_DRAFT, name="hybrid", block_pattern=("attn", "rec"))
    if pkg is JT:
        return JT.ModelConfig(**fields, remat=False)
    return PT.ModelConfig(**fields)


def _vocab128(pkg):
    fields = dict(_DRAFT, name="v128", vocab=128)
    if pkg is JT:
        return JT.ModelConfig(**fields, remat=False)
    return PT.ModelConfig(**fields)


@pytest.mark.parametrize("case", ["dense", "prefix", "vocab", "hybrid-draft",
                                  "hybrid-target"])
def test_validate_speculation_rejects_what_the_reference_rejects(case):
    def call(validate, pkg, tgt, draft):
        kw = dict(kv_layout="dense" if case == "dense" else "paged",
                  prefix_sharing=case == "prefix")
        if case == "vocab":
            draft = _vocab128(pkg)
        elif case == "hybrid-draft":
            draft = _hybrid(pkg)
        elif case == "hybrid-target":
            tgt = _hybrid(pkg)
        with pytest.raises(ValueError) as err:
            validate(tgt, draft, **kw)
        return str(err.value)

    assert (call(validate_speculation, PT, TGT, DRAFT)
            == call(j_validate, JT, JTGT, JDRAFT))
    validate_speculation(TGT, DRAFT, kv_layout="paged", prefix_sharing=False)


# ---------------------------------------------------------------------
# serve() and the CLI, against the JAX package's serve()
# ---------------------------------------------------------------------
SMOKE_J = dataclasses.replace(jqwen.SMOKE, compute_dtype=jnp.float32)
SMOKE_P = dataclasses.replace(pqwen.SMOKE, compute_dtype=torch.float32)
SERVE = dict(requests=6, prompt_len=6, gen_len=8, rate=1e9, slots=3)


@pytest.fixture(scope="module")
def smoke_weights():
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   SMOKE_J))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(SMOKE_P, tree, device="cpu"))


@pytest.fixture
def float32_smoke(monkeypatch, smoke_weights):
    """Both packages serve the float32 SMOKE qwen2 on the same weights (the
    draft, qwen2_1_5b by default, too)."""
    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=SMOKE_J))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=SMOKE_P))
    monkeypatch.setattr(japi, "build_params",
                        lambda cfg, mesh: smoke_weights[0])
    monkeypatch.setattr(papi, "build_params",
                        lambda cfg, dev: smoke_weights[1])


def _opts(api, **overrides):
    o = api.ServeOptions()
    groups = o.flat_fields()
    for name, value in dict(SERVE, **overrides).items():
        setattr(getattr(o, groups[name]), name, value)
    return o


def test_serve_forced_speculation_equals_plain_and_the_reference(
        float32_smoke, capsys):
    opts = dict(speculate=True, draft_k=2, device_model="tpu-v5e")
    plain = papi.serve(_opts(papi), device="cpu")
    got = papi.serve(_opts(papi, **opts), device="cpu")
    want = japi.serve(_opts(japi, **opts))
    assert got.summary["requests_done"] == SERVE["requests"]
    assert got.outputs == plain.outputs == want.outputs
    spec = got.speculation
    assert spec["engaged"] and spec["forced"] and spec["k"] == 2
    assert spec["n_rounds"] > 0 and spec["acceptance_rate"] == 1.0
    assert spec.keys() == want.speculation.keys()
    assert spec["decision"] == want.speculation["decision"]
    assert ({k: spec[k] for k in ("n_rounds", "n_proposed", "n_accepted",
                                  "n_committed")}
            == {k: want.speculation[k] for k in ("n_rounds", "n_proposed",
                                                 "n_accepted",
                                                 "n_committed")})
    # the disaggregated decode engine speculates too
    dis = papi.serve(_opts(papi, speculate=True, draft_k=2,
                           placement="disagg"), device="cpu")
    assert dis.outputs == plain.outputs
    assert dis.speculation["n_rounds"] > 0
    # the CLI prints the reference's speculation lines
    pserve_cli.main(["--device", "cpu", "--speculate", "--draft-k", "2",
                     "--requests", "2", "--prompt-len", "4", "--gen-len",
                     "4", "--rate", "1e9", "--slots", "2"])
    out = capsys.readouterr().out
    assert "[serve] speculation: draft qwen2_1_5b k=2" in out
    assert "[forced]" in out and "rounds," in out
    assert "requests_done: 2" in out


def test_serve_priced_fallback_equals_the_reference(float32_smoke):
    """--speculate alone: the self-draft prices worse than plain decode,
    so the run serves plain and reports the JAX package's decision (both
    priced on a device model the two packages define)."""
    opts = dict(speculate=True, device_model="tpu-v5e")
    got = papi.serve(_opts(papi, **opts), device="cpu")
    want = japi.serve(_opts(japi, **opts))
    plain = papi.serve(_opts(papi), device="cpu")
    assert got.speculation == want.speculation
    assert got.speculation["priced_fallback"] is True
    assert got.outputs == plain.outputs == want.outputs
    # on the port's default device model too
    h100 = papi.serve(_opts(papi, speculate=True), device="cpu")
    assert h100.speculation["priced_fallback"] is True
    assert h100.speculation["decision"] == choose_speculation(
        SMOKE_P, SMOKE_P, kv_len=SERVE["prompt_len"] + SERVE["gen_len"],
        n_tokens=SERVE["slots"], acceptance=0.8, device_name="nvidia-h100",
        draft_name="qwen2_1_5b").summary()
