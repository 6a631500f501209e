"""The port's serving runtime against the JAX package's, on the CPU.

* ``KVPool``: the same random alloc / write / free / COW sequences drive the
  port's pool and the JAX package's, and every lease, refcount and stat
  must agree; the allocator, refcount and copy-on-write properties of
  tests/test_paged.py and tests/test_prefix.py are checked on the port's.
* The engine: greedy tokens of ``EngineLoop.run`` (paged, float32) equal the
  JAX package's for the same weights, with and without prefix sharing, and
  streaming delivers exactly those tokens.
* ``SlotEngine.dispatch`` copies the ``active`` mask before it returns, so a
  caller that changes its array right after cannot change what runs.

Where a test drives the JAX package's ``SlotEngine`` directly it calls
``eng.sync()`` after each ``dispatch``: that engine's dispatch returns before
its jitted burst has read the caller's ``active`` array, and the caller here
changes the array right after (the race that makes two tests of
tests/test_prefix.py fail at random).  The sync is a pure wait and changes
no output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving import EngineLoop as JLoop
from repro.serving import KVPool as JPool
from repro.serving import SlotEngine as JEngine
from repro.serving import batcher as jbatcher
from repro.serving import prefix_shared_workload as j_prefix_workload
from repro.serving import synthetic_workload as j_workload
from repro_torch.models import transformer as PT
from repro_torch.obs import Observability, Tracer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import EngineLoop, KVPool, Request, SlotEngine
from repro_torch.serving import batcher as pbatcher
from repro_torch.serving.request import (prefix_shared_workload,
                                         synthetic_workload)

torch.set_num_threads(2)

_FIELDS = dict(name="serve-tiny", n_layers=3, d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab=64, qkv_bias=True,
               attention_impl="dot")
JCFG = JT.ModelConfig(**_FIELDS, compute_dtype=jnp.float32, remat=False)
PCFG = PT.ModelConfig(**_FIELDS, compute_dtype=torch.float32)
MAX_LEN, BS = 32, 8


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   JCFG))
    # the zero-initialized norms and biases get values, so they matter
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(
            np.float32) if _norm_or_bias(path) else a, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(PCFG, tree, device="cpu"))


def _norm_or_bias(path) -> bool:
    name = str(getattr(path[-1], "key", ""))
    return name.startswith("ln") or name in ("final_norm", "bq", "bk", "bv")


def _virtual_clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


# ------------------------------------------------------------------ pool
def _pool_state(pool):
    return ({rid: (l.slot, list(l.blocks), l.written_tokens,
                   l.shared_tokens) for rid, l in pool._leases.items()},
            dict(pool._block_refs), sorted(pool._free_blocks),
            pool.stats())


@pytest.mark.parametrize("sharing", [False, True])
def test_pool_follows_the_reference_through_churn(sharing):
    """One random sequence of admits, writes, COW consumption and frees
    drives both pools; every lease, refcount, free list and stat agrees
    after every operation, and the refcount conservation law holds."""
    rng = np.random.default_rng(3)
    kw = dict(block_size=8, total_blocks=32, prefix_sharing=sharing)
    pools = (KVPool(6, 64, **kw), JPool(6, 64, **kw))
    families = [tuple(int(t) for t in rng.integers(0, 997, size=(16,)))
                for _ in range(3)]
    live = []
    for step in range(300):
        if live and (rng.random() < 0.45 or len(live) == 6):
            rid = live.pop(int(rng.integers(0, len(live))))
            for pool in pools:
                pool.free(rid)
        else:
            rid = 1000 + step
            prompt = families[int(rng.integers(0, 3))] + tuple(
                int(t) for t in rng.integers(1000, 2000,
                                             size=(int(rng.integers(1, 17)),)))
            n = min(len(prompt) + int(rng.integers(0, 17)), 64)
            fits = [p.can_admit(n, prompt) for p in pools]
            assert fits[0] == fits[1]
            if fits[0]:
                slots = [p.alloc(rid, n, prompt=prompt) for p in pools]
                assert slots[0] == slots[1]
                live.append(rid)
                if rng.random() < 0.5:
                    assert pools[0].consume_cow(rid) == pools[1].consume_cow(
                        rid)
                lease = pools[0].lease(rid)
                w = int(rng.integers(
                    0, lease.reserved_tokens - lease.written_tokens + 1))
                for pool in pools:
                    pool.note_write(rid, w)
        port, want = (_pool_state(p) for p in pools)
        assert port == want
        held = {}
        for rid in live:
            for b in pools[0].lease(rid).blocks:
                held[b] = held.get(b, 0) + 1
        for ops in pools[0]._pending_cow.values():
            for src, _ in ops:
                held[src] = held.get(src, 0) + 1
        assert held == pools[0]._block_refs
        assert (pools[0].free_block_count + len(pools[0]._block_refs)
                == pools[0].total_blocks)


def test_pool_block_table_order_padding_and_double_free():
    pool = KVPool(n_slots=2, max_seq=64, block_size=16)
    pool.alloc(rid=5, n_tokens=33)                   # 3 blocks
    table = pool.block_table(5, pad_to=4)
    assert table.dtype == np.int32 and table.shape == (4,)
    assert table[:3].tolist() == pool.lease(5).blocks
    assert table[3] == 0
    with pytest.raises(ValueError):
        pool.block_table(5, pad_to=2)
    with pytest.raises(ValueError):
        pool.alloc(rid=5, n_tokens=1)                # double alloc
    pool.free(5)
    with pytest.raises(ValueError):
        pool.free(5)                                 # double free


@pytest.mark.parametrize("divergence", [BS * 2 - 1, BS * 2, BS * 2 + 1])
def test_cow_exactly_at_first_divergent_token(divergence):
    pool = KVPool(4, MAX_LEN, block_size=BS, prefix_sharing=True)
    donor = tuple(range(24))
    pool.alloc(1, 28, prompt=donor)
    pool.note_write(1, 24)
    sharer = donor[:divergence] + tuple(55 + i for i in range(4))
    pool.alloc(2, len(sharer) + 4, prompt=sharer)
    assert pool.lease(2).shared_tokens == divergence
    ops = pool.consume_cow(2)
    if divergence % BS == 0:
        assert ops == []
    else:
        assert ops == [(pool.lease(1).blocks[divergence // BS],
                        pool.lease(2).blocks[divergence // BS])]


def test_shared_pages_outlive_the_donor_and_cow_refs_are_released():
    pool = KVPool(4, MAX_LEN, block_size=BS, prefix_sharing=True)
    donor = tuple(range(24))
    pool.alloc(1, 28, prompt=donor)
    pool.note_write(1, 24)
    pool.alloc(2, 28, prompt=donor[:20] + (60, 61, 62, 63))
    src = pool.lease(1).blocks[2]
    assert pool._block_refs[src] == 2                # donor + pending COW
    pool.free(2)                                     # COW never consumed
    assert pool._block_refs[src] == 1
    pool.alloc(3, 24, prompt=donor[:16] + (40, 41))
    shared = pool.lease(3).blocks[:2]
    pool.free(1)
    assert all(pool._block_refs[b] == 1 for b in shared)
    assert pool.shared_prefix_tokens(donor[:16] + (50,)) == 16
    pool.free(3)
    assert pool._block_refs == {} and pool._prefix_index == {}
    assert pool.free_block_count == pool.total_blocks


# --------------------------------------------------------------- batcher
def test_admission_prices_like_the_reference():
    """Same device model, same price: the port's batcher reproduces the JAX
    package's step-time model and SLO budget exactly (on the TPU model
    both registries carry), and prices the port's H100 as well."""
    for kv_len, n in [(32, 1), (256, 4), (2048, 8)]:
        assert (pbatcher.step_time_model(PCFG, kv_len, n, "tpu-v5e")
                == jbatcher.step_time_model(JCFG, kv_len, n, "tpu-v5e"))
    slo = jbatcher.step_time_model(JCFG, MAX_LEN, 3, "tpu-v5e")
    assert (pbatcher.token_budget_for_slo(PCFG, MAX_LEN, 8, slo, "tpu-v5e")
            == jbatcher.token_budget_for_slo(JCFG, MAX_LEN, 8, slo,
                                             "tpu-v5e") == 3)
    pool = KVPool(4, MAX_LEN, block_size=BS)
    assert pbatcher.ContinuousBatcher(PCFG, pool).priced_step_s(4) > 0


# ---------------------------------------------------------------- engine
def _workload(fn):
    return fn(9, rate=1e9, vocab=JCFG.vocab, prompt_lens=(4, 11),
              gen_lens=(1, 3, 9), seed=11)


def _prefix_workload(fn):
    return fn(8, rate=1e9, vocab=JCFG.vocab, shared_prefix_len=12,
              shared_frac=0.75, suffix_lens=(3, 5), gen_lens=(2, 6), seed=4)


@pytest.fixture(scope="module")
def reference_outputs(weights):
    """Greedy tokens of the JAX package's paged EngineLoop, plain and with
    prefix sharing."""
    out = {}
    for sharing, reqs in ((False, _workload(j_workload)),
                          (True, _prefix_workload(j_prefix_workload))):
        loop = JLoop(JCFG, weights[0], n_slots=3, max_seq=MAX_LEN,
                     block_size=BS, kv_layout="paged",
                     prefix_sharing=sharing)
        metrics = loop.run(reqs, now_fn=_virtual_clock())
        assert metrics.n_done == len(reqs)
        out[sharing] = {r.rid: r.output for r in reqs}
    return out


@pytest.mark.parametrize("sharing", [False, True])
def test_engine_loop_greedy_tokens_match_the_reference(
        weights, reference_outputs, sharing):
    reqs = (_prefix_workload(prefix_shared_workload) if sharing
            else _workload(synthetic_workload))
    loop = EngineLoop(PCFG, weights[1], n_slots=3, max_seq=MAX_LEN,
                      block_size=BS, prefix_sharing=sharing, device="cpu")
    metrics = loop.run(reqs, now_fn=_virtual_clock())
    assert metrics.n_done == len(reqs) and metrics.n_dropped == 0
    assert {r.rid: r.output for r in reqs} == reference_outputs[sharing]
    if sharing:
        assert loop.pool.prefix_hits > 0
    assert loop.pool.free_block_count == loop.pool.total_blocks


def test_streaming_delivers_exactly_the_completion_rows(weights,
                                                        reference_outputs):
    deltas = {}
    reqs = _workload(synthetic_workload)
    loop = EngineLoop(PCFG, weights[1], n_slots=3, max_seq=MAX_LEN,
                      block_size=BS, device="cpu")
    metrics = loop.run(reqs, now_fn=_virtual_clock(),
                       on_delta=lambda d: deltas.setdefault(
                           d.rid, []).extend(d.tokens))
    assert deltas == reference_outputs[False]
    assert metrics.tokens_streamed == metrics.tokens_out
    for r in reqs:
        assert r.ttft_dispatch <= r.ttft
    summary = metrics.summary()
    assert summary["requests_done"] == len(reqs)
    assert summary["ttft_p50_s"] is not None


def test_tracing_records_every_request_and_changes_no_output(
        weights, reference_outputs):
    obs = Observability(tracer=Tracer())
    reqs = _workload(synthetic_workload)
    loop = EngineLoop(PCFG, weights[1], n_slots=3, max_seq=MAX_LEN,
                      block_size=BS, obs=obs, device="cpu")
    metrics = loop.run(reqs, now_fn=_virtual_clock())
    assert {r.rid: r.output for r in reqs} == reference_outputs[False]
    tracer = obs.tracer
    for name in ("queued", "prefill", "decode"):
        assert sorted(e.tid for e in tracer.spans(name)) == sorted(
            r.rid for r in reqs), name
    bursts = tracer.spans("burst")
    assert sum(e.args["steps"] for e in bursts) == metrics.n_steps
    assert tracer.n_open == 0
    snap = obs.registry.snapshot()
    assert snap["counters"]["requests_done"] == len(reqs)
    assert snap["histograms"]["ttft_s"]["count"] == len(reqs)
    assert snap["gauges"]["slots_in_flight"] == 0


def test_engine_refuses_the_card_it_does_not_have(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineLoop(PCFG, weights[1], n_slots=2, max_seq=MAX_LEN)


# ------------------------------------------ slot engine, driven directly
def _serve_one(eng, pool, rid, prompt, gen, *, sharing, reference):
    """Admit + bind + run one request to completion on a SlotEngine, then
    mark its slot inactive right after the last dispatch (its lease, and so
    its published pages, stay alive).  Returns (greedy tokens, shared)."""
    req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                  max_new_tokens=gen)
    req.slot = pool.alloc(rid, req.prompt_len + gen,
                          prompt=tuple(prompt) if sharing else None)
    shared = pool.shared_tokens(rid) if sharing else 0
    eng.bind(req, steps_total=req.prompt_len - shared + gen - 1,
             start_pos=shared)
    s = req.slot
    while eng.steps_done[s] < eng.steps_total[s]:
        eng.dispatch(1, eng.active)
        if reference:
            eng.sync()      # the reference reads `active` asynchronously
    eng.active[s] = False
    return eng.pull_output(s)[:gen].tolist(), shared


@pytest.mark.parametrize("split", [20, 16])
def test_shared_vs_unshared_identical_and_equal_to_reference(weights, split):
    """A sharer mapping the donor's pages (with a COW tail at split 20, on
    a block boundary at 16) decodes exactly what it decodes unshared, and
    what the JAX package's SlotEngine decodes."""
    rng = np.random.default_rng(5)
    donor = rng.integers(0, JCFG.vocab, size=(24,))
    sharer = np.concatenate([donor[:split],
                             rng.integers(0, JCFG.vocab, size=(5,))])
    runs = {}
    for name, Engine, Pool, params in (
            ("port", SlotEngine, KVPool, weights[1]),
            ("reference", JEngine, JPool, weights[0])):
        kw = {"device": "cpu"} if name == "port" else {"kv_layout": "paged"}
        for sharing in (False, True):
            pool = Pool(n_slots=2, max_seq=MAX_LEN, block_size=BS,
                        prefix_sharing=sharing)
            eng = Engine(PCFG if name == "port" else JCFG, params, pool,
                         **kw)
            outs = [_serve_one(eng, pool, rid, p, g, sharing=sharing,
                               reference=name == "reference")
                    for rid, (p, g) in enumerate([(donor, 4), (sharer, 5)])]
            runs[name, sharing] = outs
            if sharing:
                assert outs[1][1] == split
                assert pool.cow_copies == (split % BS != 0)
    for key in runs:
        assert [o[0] for o in runs[key]] == [o[0] for o in
                                             runs["reference", False]], key


def test_dispatch_copies_the_active_mask(weights):
    """The caller may change its mask right after ``dispatch`` returns:
    the queued steps ran with the mask as it was at the call."""
    prompt = np.arange(5, dtype=np.int32) + 7

    def run(mutate):
        pool = KVPool(n_slots=2, max_seq=MAX_LEN, block_size=BS)
        eng = SlotEngine(PCFG, weights[1], pool, device="cpu")
        req = Request(rid=0, prompt=prompt, max_new_tokens=6)
        req.slot = pool.alloc(0, req.total_tokens)
        eng.bind(req, steps_total=req.prompt_len + 5)
        mask = eng.active.copy()
        eng.dispatch(int(eng.steps_total[req.slot]), mask)
        if mutate:
            mask[:] = False              # after dispatch has returned
        return eng.pull_output(req.slot)[:6].tolist(), int(
            eng.cache["pos"][req.slot])

    assert run(mutate=True) == run(mutate=False)
    assert run(mutate=True)[1] == len(prompt) + 5
