"""The port's disaggregated serving and slot hand-off against the JAX
package's, on the CPU.

* ``DisaggregatedEngineLoop`` at the settings of tests/test_placement.py
  (TINY, 2 prefill slots, 3 decode slots, 3 colocated): its greedy tokens
  equal the port's colocated ``EngineLoop``'s bit for bit and the JAX
  package's ``DisaggregatedEngineLoop``'s at float32, asynchronous and
  synchronous, paged (with and without prefix sharing) and dense; its
  hand-off count, bytes and modeled seconds equal the JAX package's.
* The JAX package's tests of priced hand-offs, shedding and per-phase
  budgets, mirrored.
* ``import_slot`` writes in place (every cache and buffer tensor keeps its
  ``data_ptr()``, which the captured CUDA graph reads), a snapshot holds
  copies (it is unchanged after its slot is rebound and stepped), and the
  layout and lease checks raise the JAX package's errors.
* ``serve()`` with ``--placement disagg`` gives the JAX package's tokens
  and hand-off ledger.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from repro.configs import registry as jregistry
from repro.core import device_models as jdm
from repro.models import transformer as JT
from repro.serving import DisaggregatedEngineLoop as JDisagg
from repro.serving import prefix_shared_workload as j_prefix_workload
from repro.serving import synthetic_workload as j_workload
from repro_torch.configs import registry as pregistry
from repro_torch.core import device_models as pdm
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import DriftAlert, Observability, PerfWatchdog, Tracer
from repro_torch.serving import (EngineLoop, KVPool, Request, SlotEngine,
                                 SpecPlan)
from repro_torch.serving import api as papi
from repro_torch.serving.disagg import (MAX_PENDING_HANDOFFS,
                                        DisaggregatedEngineLoop,
                                        HandoffLedger)
from repro_torch.serving.engine_loop import (snapshot_ready, snapshot_wait,
                                             state_to_device)
from repro_torch.serving.request import (prefix_shared_workload,
                                         synthetic_workload)

torch.set_num_threads(2)

_TINY = dict(name="place-tiny", n_layers=3, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab=64, attention_impl="dot")
JCFG = JT.ModelConfig(**_TINY, compute_dtype=jnp.float32, remat=False)
PCFG = PT.ModelConfig(**_TINY, compute_dtype=torch.float32)
MAX_LEN = 8 + 12


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   JCFG))

    def redraw(path, a):  # norms start at one: give them values
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name == "final_norm":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(PCFG, tree, device="cpu"))


def _virtual_clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _workload(fn, sharing):
    if sharing:
        return fn(9, rate=1e9, vocab=JCFG.vocab, shared_prefix_len=18,
                  shared_frac=0.75, suffix_lens=(2, 4), gen_lens=(1, 3, 6),
                  seed=4)
    return fn(9, rate=1e9, vocab=JCFG.vocab, prompt_lens=(4, 8),
              gen_lens=(1, 3, 6, 12), seed=11)


def _outputs(reqs):
    return {r.rid: r.output for r in reqs}


PAIR = dict(prefill_device=pdm.K40_ROOFLINE, decode_device=pdm.DE5_ROOFLINE)
JPAIR = dict(prefill_device=jdm.K40_ROOFLINE, decode_device=jdm.DE5_ROOFLINE)


# --------------------------------------------- the loop against both
@pytest.mark.parametrize("layout,sharing", [("paged", False),
                                            ("paged", True),
                                            ("dense", False)])
def test_disaggregated_tokens_equal_colocated_and_the_reference(
        weights, layout, sharing):
    max_len = MAX_LEN + (8 if sharing else 0)
    kw = dict(max_seq=max_len, kv_layout=layout, prefix_sharing=sharing)
    reqs = _workload(synthetic_workload if not sharing
                     else prefix_shared_workload, sharing)
    colo = EngineLoop(PCFG, weights[1], n_slots=3, device="cpu", **kw)
    assert colo.run(reqs, now_fn=_virtual_clock()).n_done == 9
    colocated = _outputs(reqs)

    for async_handoff in (True, False):
        reqs = _workload(j_workload if not sharing else j_prefix_workload,
                         sharing)
        ref = JDisagg(JCFG, weights[0], n_prefill_slots=2, n_decode_slots=3,
                      async_handoff=async_handoff, **kw, **JPAIR)
        ref.run(reqs, now_fn=_virtual_clock())
        reference = _outputs(reqs)
        reqs = _workload(synthetic_workload if not sharing
                         else prefix_shared_workload, sharing)
        dis = DisaggregatedEngineLoop(
            PCFG, weights[1], n_prefill_slots=2, n_decode_slots=3,
            async_handoff=async_handoff, device="cpu", **kw, **PAIR)
        m = dis.run(reqs, now_fn=_virtual_clock())
        assert m.n_done == 9 and m.n_dropped == 0
        assert _outputs(reqs) == colocated
        assert _outputs(reqs) == reference
        # every request crossed the boundary once (the prefix indexes served
        # the same pages); both pools drained
        assert dis.handoff.n_handoffs == ref.handoff.n_handoffs == 9
        assert dis.handoff.bytes_moved == ref.handoff.bytes_moved > 0
        assert dis.handoff.modeled_s == ref.handoff.modeled_s > 0
        assert dis.handoff.modeled_energy_j == ref.handoff.modeled_energy_j
        assert dis.prefill.pool.free_slot_count == 2
        assert dis.decode.pool.free_slot_count == 3
        assert dis.decode.pool.free_block_count == \
            dis.decode.pool.total_blocks
        assert (dis.prefill.pool.prefix_hits, dis.decode.pool.prefix_hits) \
            == (ref.prefill.pool.prefix_hits, ref.decode.pool.prefix_hits)
        if sharing:
            assert dis.prefill.pool.prefix_hits > 0
            assert dis.decode.pool.prefix_hits > 0


def test_handoff_priced_on_the_phase_devices(weights):
    reqs = synthetic_workload(4, rate=1e9, vocab=PCFG.vocab,
                              prompt_lens=(4,), gen_lens=(4,), seed=3)
    dis = DisaggregatedEngineLoop(
        PCFG, weights[1], n_prefill_slots=2, n_decode_slots=2, max_seq=8,
        device="cpu", **PAIR)
    dis.run(reqs, now_fn=_virtual_clock())
    assert dis.handoff.n_handoffs == 4
    assert dis.handoff.modeled_s > 0
    assert dis.handoff.modeled_s == pytest.approx(
        dis.handoff.bytes_moved
        / min(pdm.K40_ROOFLINE.mem_bw, pdm.DE5_ROOFLINE.mem_bw))
    # one page of K and V per layer, three int32 scalars (position, prompt
    # length, last token) and the prompt and output rows
    page = 2 * PCFG.n_layers * PCFG.n_kv_heads * 16 * PCFG.hd * 4
    assert dis.handoff.bytes_moved == 4 * (page + 3 * 4 + 2 * 8 * 4)


def test_disaggregated_sheds_requests_that_never_fit_decode(weights):
    big = Request(rid=0, prompt=np.zeros((30,), np.int32), max_new_tokens=8)
    ok = Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                 max_new_tokens=4)
    dis = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=2,
                                  n_decode_slots=2, max_seq=16,
                                  device="cpu")
    m = dis.run([big, ok], now_fn=_virtual_clock())
    assert m.n_done == 1 and m.n_dropped == 1
    assert big.output == [] and len(ok.output) == 4


def test_per_phase_batchers_budget_independently(weights):
    dis = DisaggregatedEngineLoop(
        PCFG, weights[1], n_prefill_slots=2, n_decode_slots=4, max_seq=16,
        device="cpu", **PAIR)
    pre, dec = dis.batchers
    assert (pre.phase, dec.phase) == ("prefill", "decode")
    assert pre.device_name == "nvidia-k40-roofline"
    assert dec.device_name == "altera-de5-roofline"
    assert pre.token_budget <= 2 and dec.token_budget <= 4


def test_engines_share_one_set_of_weights_and_trace_the_handoffs(weights):
    obs = Observability(tracer=Tracer())
    dis = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=2,
                                  n_decode_slots=3, max_seq=MAX_LEN,
                                  obs=obs, device="cpu")
    assert dis.decode.params["embed"] is dis.prefill.params["embed"]
    assert (dis.decode.params["layers"][0]["attn"]["wq"]
            is dis.prefill.params["layers"][0]["attn"]["wq"])
    reqs = _workload(synthetic_workload, False)
    dis.run(reqs, now_fn=_virtual_clock())
    spans = obs.tracer.spans("handoff")
    assert sorted(e.tid for e in spans) == sorted(r.rid for r in reqs)
    assert sum(e.args["bytes"] for e in spans) == dis.handoff.bytes_moved
    assert obs.tracer.n_open == 0
    assert obs.registry.snapshot()["counters"]["handoff_n"] == 9
    assert MAX_PENDING_HANDOFFS == 2 and dis.decode_target == "decode"


def test_unported_parts_raise_with_their_roadmap_item(weights):
    """Parts whose modules are not ported raise, naming their ROADMAP item.
    The name is historical for ``plan=``: speculative decoding on the decode
    engine is ported, so a plan now builds the decoder beside it; and for
    recurrent layers and cross-attention (item 7), which are ported too, so
    a hybrid config and a gated cross-attention config now build (the
    latter with a cross row per slot on both engines); and for the drift
    hook (item 6c, re-placement and live migration), which is ported too:
    handed an alert for a stream the watchdog has not observed, it keeps
    the analytic model and re-prices nothing, as the JAX package's does."""
    plan = SpecPlan(draft_cfg=PCFG, draft_params=weights[1], k=2)
    spec = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=1,
                                   n_decode_slots=1, max_seq=8, plan=plan,
                                   device="cpu")
    assert spec.spec.eng is spec.decode and spec.spec.plan is plan
    # a self-draft shares the decode engine's weights
    assert spec.spec.draft.params["embed"] is spec.decode.params["embed"]
    hybrid = dataclasses.replace(PCFG, block_pattern=("rec", "attn"))
    hybrid_params = PT.init_params(hybrid, 0, device="cpu")
    built = DisaggregatedEngineLoop(hybrid, hybrid_params, n_prefill_slots=1,
                                    n_decode_slots=1, max_seq=8,
                                    device="cpu")
    assert "rec" in built.decode.cache["layers"][0]
    cross = dataclasses.replace(PCFG, cross_attn_every=2, frontend="vision",
                                img_seq=4)
    built = DisaggregatedEngineLoop(cross, PT.init_params(cross, 0,
                                                          device="cpu"),
                                    n_prefill_slots=1, n_decode_slots=2,
                                    max_seq=8, device="cpu")
    for eng, n in ((built.prefill, 1), (built.decode, 2)):
        assert tuple(eng.cache["cross"].shape) == (n, 4, PCFG.d_model)
    dis = DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=1,
                                  n_decode_slots=1, max_seq=8, device="cpu")
    watchdog = PerfWatchdog()
    alert = DriftAlert(engine="decode", phase="decode", t=0.0,
                       ewma_ratio=3.0, priced_step_s=1e-3,
                       observed_step_s=3e-3, n_obs=4, batch=1,
                       direction="slow")
    budget = dis.decode_batcher.token_budget
    dis.on_drift(alert, watchdog)
    assert watchdog.reprices == [] and dis.decode_batcher.n_reprices == 0
    assert dis.decode_batcher.token_budget == budget
    assert dis.decode_target == "decode"


def test_loop_refuses_the_card_it_does_not_have(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedEngineLoop(PCFG, weights[1], n_prefill_slots=1,
                                n_decode_slots=1, max_seq=8)


def test_ledger_view_over_the_registry():
    from repro_torch.core.cost_model import transfer_cost
    ledger = HandoffLedger()
    price = transfer_cost(100, pdm.K40_ROOFLINE, pdm.DE5_ROOFLINE)
    ledger.record(100, price, stall_s=-1.0, overlap_s=0.25)
    ledger.record(50, price, live=True)
    assert ledger.stats() == {
        "n_handoffs": 2, "bytes_moved": 150,
        "modeled_s": 2 * price.t_transfer,
        "modeled_energy_j": 2 * price.energy_j, "stall_s": 0.0,
        "overlap_s": 0.25, "n_live_migrations": 1}


# ---------------------------------------------- the slot hand-off itself
def _engine_with_request(weights, layout, *, steps, rid=0, prompt_len=6,
                         gen=8, seed=0):
    pool = KVPool(n_slots=2, max_seq=MAX_LEN)
    eng = SlotEngine(PCFG, weights[1], pool, kv_layout=layout, device="cpu")
    rng = np.random.default_rng(seed)
    req = Request(rid=rid, prompt=rng.integers(0, PCFG.vocab,
                                               size=(prompt_len,)),
                  max_new_tokens=gen)
    req.slot = pool.alloc(rid, req.total_tokens)
    eng.bind(req, steps_total=req.prompt_len + gen - 1)
    eng.dispatch(steps, eng.active.copy())
    return eng, pool, req


def _buffers(eng):
    out = [eng.cache["pos"], eng._prompts, eng._plens, eng._last_tok,
           eng._out_buf] + [a for layer in eng.cache["layers"]
                            for a in layer.values()]
    if "block_tables" in eng.cache:
        out.append(eng.cache["block_tables"])
    return out


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_import_slot_writes_in_place(weights, layout):
    """The graph a card replays reads fixed addresses: an import keeps every
    cache and buffer tensor's storage, and the adopted request finishes
    with the tokens it gets without moving."""
    src, src_pool, req = _engine_with_request(weights, layout, steps=7)
    stay, _, same = _engine_with_request(weights, layout, steps=7)
    state = src.export_slot(req.slot)
    pool = KVPool(n_slots=3, max_seq=MAX_LEN)
    dst = SlotEngine(PCFG, weights[1], pool, kv_layout=layout, device="cpu")
    ptrs = [t.data_ptr() for t in _buffers(dst)]
    src.release(req)
    req.slot = pool.alloc(req.rid, req.total_tokens)
    pool.note_write(req.rid, 7)
    remaining = req.prompt_len + req.max_new_tokens - 1 - 7
    dst.adopt(req, state, steps_total=remaining)
    assert [t.data_ptr() for t in _buffers(dst)] == ptrs
    dst.dispatch(remaining, dst.active.copy())
    stay.dispatch(remaining, stay.active.copy())
    assert (dst.pull_output(req.slot)[:8].tolist()
            == stay.pull_output(same.slot)[:8].tolist())


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_snapshot_is_unchanged_after_its_slot_is_rebound_and_stepped(
        weights, layout):
    eng, pool, req = _engine_with_request(weights, layout, steps=9)
    state = eng.export_slot(req.slot)
    kept = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items() if k != "layers"}
    kept_layers = [{n: a.clone() for n, a in layer.items()}
                   for layer in state["layers"]]
    eng.release(req)
    # a new tenant in the same slot and pages, stepped past the old one
    nxt = Request(rid=1, prompt=np.arange(7, dtype=np.int32) + 3,
                  max_new_tokens=8)
    nxt.slot = pool.alloc(1, nxt.total_tokens)
    assert nxt.slot == req.slot
    if layout == "paged":
        assert pool.lease(1).blocks[0] in pool.block_table(1, pad_to=2)
    eng.bind(nxt, steps_total=nxt.prompt_len + 7)
    eng.dispatch(12, eng.active.copy())
    for key, want in kept.items():
        got = state[key]
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), key
        else:
            assert got == want, key
    for layer, want in zip(state["layers"], kept_layers):
        for name, a in layer.items():
            assert torch.equal(a, want[name])
    # and the snapshot did not share the engine's storage to begin with
    engine_ptrs = {t.data_ptr() for t in _buffers(eng)}
    for layer in state["layers"]:
        for a in layer.values():
            assert a.data_ptr() not in engine_ptrs


def test_paged_export_ships_only_written_pages(weights):
    eng, pool, req = _engine_with_request(weights, "paged", steps=17,
                                          prompt_len=6, gen=14)
    state = eng.export_slot(req.slot)
    assert state["kv_tokens"] == 17
    assert all(a.shape[0] == 2 for layer in state["layers"]
               for a in layer.values())                  # ceil(17 / 16)
    lease = pool.lease(req.rid)
    for layer, shipped in zip(eng.cache["layers"], state["layers"]):
        for name, a in layer.items():
            assert torch.equal(shipped[name], a[lease.blocks[:2]])
    assert SlotEngine.state_nbytes(state) == (
        2 * 3 * 2 * 2 * 16 * 8 * 4 + 3 * 4 + 2 * MAX_LEN * 4)


def test_import_checks_layout_cross_rows_and_the_lease(weights):
    eng, pool, req = _engine_with_request(weights, "paged", steps=17,
                                          prompt_len=6, gen=14)
    state = eng.export_slot(req.slot)
    dense = SlotEngine(PCFG, weights[1], KVPool(2, MAX_LEN),
                       kv_layout="dense", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        dense.import_slot(0, state)
    other = SlotEngine(PCFG, weights[1], KVPool(2, MAX_LEN),
                       kv_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="dest_blocks"):
        other.import_slot(0, state)
    with pytest.raises(ValueError, match="2 written pages"):
        other.import_slot(0, state, dest_blocks=[3])
    with pytest.raises(ValueError, match="cross-attention"):
        other.import_slot(0, dict(state, cross=torch.zeros(1)),
                          dest_blocks=[3, 4])


def test_skip_blocks_leaves_shared_pages_unwritten(weights):
    eng, pool, req = _engine_with_request(weights, "paged", steps=17,
                                          prompt_len=6, gen=14)
    state = eng.export_slot(req.slot)
    dst = SlotEngine(PCFG, weights[1], KVPool(2, MAX_LEN),
                     kv_layout="paged", device="cpu")
    before = [{n: a.clone() for n, a in layer.items()}
              for layer in dst.cache["layers"]]
    dst.import_slot(1, state, dest_blocks=[2, 0], skip_blocks=1)
    for layer, old, shipped in zip(dst.cache["layers"], before,
                                   state["layers"]):
        for name, a in layer.items():
            assert torch.equal(a[2], old[name][2])       # skipped
            assert torch.equal(a[0], shipped[name][1])   # landed
    assert dst.cache["block_tables"][1].tolist()[:2] == [2, 0]
    assert int(dst.cache["pos"][1]) == 17


def test_state_to_device_copies_off_the_card(weights):
    eng, _, req = _engine_with_request(weights, "paged", steps=5)
    state = eng.export_slot(req.slot)
    assert state["ready"] is None and snapshot_ready(state)
    moved = state_to_device(state, "cpu")
    snapshot_wait(moved)
    assert snapshot_ready(moved) and moved["ready"] is None
    assert moved["layout"] == "paged" and moved["kv_tokens"] == 5
    assert moved["pos"].data_ptr() != state["pos"].data_ptr()
    for a, b in zip(moved["layers"], state["layers"]):
        assert torch.equal(a["k"], b["k"])
        assert a["k"].data_ptr() != b["k"].data_ptr()
    assert SlotEngine.state_nbytes(moved) == SlotEngine.state_nbytes(state)


# -------------------------------------------------------------- serve()
@pytest.fixture
def float32_tiny(monkeypatch, weights):
    """Both packages serve the float32 TINY config on the same weights."""
    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=JCFG))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=PCFG))
    monkeypatch.setattr(japi, "build_params", lambda cfg, mesh: weights[0])
    monkeypatch.setattr(papi, "build_params", lambda cfg, dev: weights[1])


def _opts(api, **fields):
    o = api.ServeOptions()
    groups = o.flat_fields()
    for name, value in dict(requests=6, prompt_len=6, gen_len=8, rate=1e9,
                            slots=3, **fields).items():
        setattr(getattr(o, groups[name]), name, value)
    return o


@pytest.mark.parametrize("fields", [
    dict(placement="disagg"),
    dict(placement="disagg", sync_handoff=True, prefill_slots=2,
         handoff_link_bw=1e9),
    dict(prefill_engine="k40-roofline", decode_engine="de5-roofline"),
], ids=["disagg", "sync", "boards"])
def test_serve_disagg_equals_the_reference(float32_tiny, fields):
    got = papi.serve(_opts(papi, **fields), device="cpu")
    want = japi.serve(_opts(japi, **fields))
    assert got.summary["requests_done"] == 6
    assert got.outputs == want.outputs
    for key in ("n_handoffs", "bytes_moved", "modeled_s",
                "modeled_energy_j", "n_live_migrations"):
        assert got.handoff[key] == want.handoff[key], key
    # the port's buildable engine is torch where the JAX package's is xla
    assert got.placement == {k: ("torch" if v == "xla" else v)
                             for k, v in want.placement.items()}
    assert got.decode_target == want.decode_target == "decode"
    assert got.pool_stats.keys() == want.pool_stats.keys()
    assert [a["phase"] for a in got.admission] == [
        a["phase"] for a in want.admission]
