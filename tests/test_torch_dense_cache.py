"""The port's dense decode caches against the JAX package's, on the CPU at
SMOKE width in float32.

* ``init_cache``/``decode_step`` (the static server's step) and
  ``init_slot_cache``/``decode_step_slots`` (the continuous engine's dense
  layout) give the JAX package's logits, on the plain SMOKE config and on
  one with ``attn_window=8`` run past its window (the rolling buffer).
* Inside the port, the paged slot step (impl ``ref``) gives the dense slot
  step's logits bit for bit, and continuous batching on either layout gives
  the static server's greedy tokens bit for bit.
* The engine's buffer contract: several ``dispatch`` calls write the same
  tensors in place (what a CUDA graph of the step needs) and give the JAX
  package's tokens.

The same weights go to both packages as numpy arrays (``params_from_numpy``),
as in tests/test_torch_lm.py; logits are held at its 2e-5 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_1_5b as jcfgs
from repro.models import transformer as JT
from repro.serving import KVPool as JPool
from repro.serving import SlotEngine as JEngine
from repro_torch.configs import qwen2_1_5b as pcfgs
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import EngineLoop, KVPool, Request, SlotEngine
from repro_torch.serving.api import Server
from repro_torch.serving.request import synthetic_workload

torch.set_num_threads(2)

LOGIT_ATOL = 2e-5
WINDOWS = [None, 8]
MAX_LEN, BS = 24, 8


def _cfgs(window):
    return (dataclasses.replace(jcfgs.SMOKE, compute_dtype=jnp.float32,
                                attn_window=window),
            dataclasses.replace(pcfgs.SMOKE, compute_dtype=torch.float32,
                                attn_window=window))


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port tree) of the same float32 values; the windowed
    config has the same parameter shapes."""
    jcfg, pcfg = _cfgs(None)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))

    def redraw(path, a):  # norms and biases start at zero: give them values
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name in ("final_norm", "bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(pcfg, tree, device="cpu"))


def _close(got: torch.Tensor, want, rows=None):
    got, want = got.numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("window", WINDOWS)
def test_decode_step_matches_the_reference(weights, window):
    """The whole batch at one position, 14 steps into a 16-long cache: past
    the window of 8, so the windowed cache wraps around its rolling
    buffer."""
    jcfg, pcfg = _cfgs(window)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, pcfg.vocab, size=(14, 2, 1), dtype=np.int32)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t))
    jcache = JT.init_cache(jcfg, 2, max_seq=16)
    pcache = PT.init_cache(pcfg, 2, max_seq=16, device="cpu")
    assert pcache["layers"][0]["k"].shape == jcache["layers"][0][0]["k"].shape[1:]
    for t in toks:
        want, jcache = step(weights[0], jcache, jnp.asarray(t))
        got, pcache = PT.decode_step(weights[1], pcfg, pcache,
                                     torch.from_numpy(t))
        _close(got, want)
    assert int(pcache["pos"]) == int(jcache["pos"]) == 14


@pytest.mark.parametrize("window", WINDOWS)
def test_decode_step_slots_matches_the_reference(weights, window):
    """Per-slot positions under a random active mask: active slots' logits
    and every position agree with the JAX package's slot step."""
    jcfg, pcfg = _cfgs(window)
    rng = np.random.default_rng(2)
    step = jax.jit(lambda p, c, t, a: JT.decode_step_slots(p, jcfg, c, t, a))
    jcache = JT.init_slot_cache(jcfg, 3, max_seq=16)
    pcache = PT.init_slot_cache(pcfg, 3, max_seq=16, device="cpu")
    for _ in range(16):
        t = rng.integers(0, pcfg.vocab, size=(3, 1), dtype=np.int32)
        active = rng.random(3) < 0.8
        want, jcache = step(weights[0], jcache, jnp.asarray(t),
                            jnp.asarray(active))
        got, pcache = PT.decode_step_slots(weights[1], pcfg, pcache,
                                           torch.from_numpy(t),
                                           torch.from_numpy(active))
        _close(got, want, rows=active)
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def test_paged_slot_step_is_bitwise_the_dense_one(weights):
    """The paged step (impl ref) over a permuted page map gives the dense
    slot step's active logits bit for bit, across page boundaries, and
    gathered through the tables its arenas hold the dense rows."""
    from repro_torch.kernels.ref import paged_gather

    _, pcfg = _cfgs(None)
    n_slots = 3
    pool = KVPool(n_slots, MAX_LEN, block_size=BS)
    for rid in (2, 0, 1):                    # leases out of slot order
        pool.alloc(rid, MAX_LEN)
    tables = torch.from_numpy(np.stack([
        pool.block_table(rid, pad_to=pool.blocks_per_slot)
        for rid in range(n_slots)]))
    dense = PT.init_slot_cache(pcfg, n_slots, MAX_LEN, device="cpu")
    paged = PT.init_slot_cache_paged(pcfg, n_slots, MAX_LEN, block_size=BS,
                                     device="cpu")
    paged["block_tables"].copy_(tables)
    rng = np.random.default_rng(3)
    for step in range(20):
        t = torch.from_numpy(rng.integers(0, pcfg.vocab, size=(n_slots, 1),
                                          dtype=np.int32))
        active = torch.from_numpy(rng.random(n_slots) < 0.8)
        ld, _ = PT.decode_step_slots(weights[1], pcfg, dense, t, active)
        lp, _ = PT.decode_step_slots_paged(weights[1], pcfg, paged, t,
                                           active, max_seq=MAX_LEN)
        assert torch.equal(ld[active], lp[active]), step
        assert torch.equal(dense["pos"], paged["pos"])
    for dl, pl in zip(dense["layers"], paged["layers"]):
        for key in ("k", "v"):
            rows = paged_gather(pl[key], tables, MAX_LEN)
            live = torch.arange(MAX_LEN) < dense["pos"][:, None]
            assert torch.equal(dl[key].transpose(1, 2)[live],
                               rows.transpose(1, 2)[live])


def _static_tokens(pcfg, params, reqs, batch, max_len):
    """Per-request greedy tokens of the port's static server: batches of
    one prompt length in arrival order, padded to ``batch`` rows by
    repeating the last (tests/test_serving.py's baseline)."""
    server = Server(pcfg, params, max_len, device="cpu")
    groups = {}
    for r in reqs:
        groups.setdefault(r.prompt_len, []).append(r)
    out = {}
    for grp in groups.values():
        for i in range(0, len(grp), batch):
            chunk = grp[i:i + batch]
            rows = [r.prompt for r in chunk]
            rows += [rows[-1]] * (batch - len(rows))
            toks = server.generate(torch.from_numpy(np.stack(rows)),
                                   max(r.max_new_tokens for r in chunk))
            for j, r in enumerate(chunk):
                out[r.rid] = toks[j, :r.max_new_tokens].tolist()
    return out


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_continuous_matches_static_greedy_tokens(weights, kv_layout):
    """3 slots for 9 requests (slots recycle, positions stagger): the
    engine's greedy tokens on either layout are the static server's."""
    _, pcfg = _cfgs(None)
    max_len = 8 + 12

    def workload():
        return synthetic_workload(9, rate=1e9, vocab=pcfg.vocab,
                                  prompt_lens=(4, 8), gen_lens=(3, 6, 12),
                                  seed=11)

    want = _static_tokens(pcfg, weights[1], workload(), 3, max_len)
    reqs = workload()
    loop = EngineLoop(pcfg, weights[1], n_slots=3, max_seq=max_len,
                      block_size=4, kv_layout=kv_layout, device="cpu")
    loop.warmup()
    clock = iter(np.arange(1, 10_000) * 1e-3)
    metrics = loop.run(reqs, now_fn=lambda: float(next(clock)))
    assert metrics.n_done == 9
    assert {r.rid: r.output for r in reqs} == want


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_dispatch_keeps_every_buffer_in_place(weights, kv_layout):
    """The CUDA graph's contract, checked on the CPU: across binds and
    several ``dispatch`` calls the engine writes pos, the last tokens, the
    active mask, the output rows and the KV caches in place (the same
    tensors at the same addresses), and its tokens are the JAX package's
    (whose engine this test syncs after each dispatch)."""
    jcfg, pcfg = _cfgs(None)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, pcfg.vocab, size=(n,), dtype=np.int32)
               for n in (5, 9, 3)]
    gens = (6, 4, 7)
    outs = {}
    for name in ("port", "reference"):
        pool = (KVPool if name == "port" else JPool)(
            n_slots=3, max_seq=MAX_LEN, block_size=BS)
        if name == "port":
            eng = SlotEngine(pcfg, weights[1], pool, kv_layout=kv_layout,
                             device="cpu")
            bufs = [eng.cache["pos"], eng._last_tok, eng._active,
                    eng._out_buf, eng._prompts, eng._plens] + [
                a for layer in eng.cache["layers"] for a in layer.values()]
            ptrs = [(id(b), b.data_ptr()) for b in bufs]
            eng.warmup()
        else:
            eng = JEngine(jcfg, weights[0], pool, kv_layout=kv_layout)
        reqs = []
        for rid, (prompt, gen) in enumerate(zip(prompts, gens)):
            req = Request(rid=rid, prompt=prompt, max_new_tokens=gen)
            req.slot = pool.alloc(rid, req.total_tokens)
            eng.bind(req, steps_total=req.prompt_len + gen - 1)
            reqs.append(req)
            eng.dispatch(2, eng.active)          # bursts interleave binds
            if name == "reference":
                eng.sync()
        while (eng.steps_done < eng.steps_total)[eng.active].any():
            left = (eng.steps_total - eng.steps_done)[eng.active]
            eng.dispatch(int(left.min()), eng.active)
            if name == "reference":
                eng.sync()
            for r in reqs:
                if eng.active[r.slot] and (eng.steps_done[r.slot]
                                           >= eng.steps_total[r.slot]):
                    eng.active[r.slot] = False
        outs[name] = [eng.pull_output(r.slot)[:r.max_new_tokens].tolist()
                      for r in reqs]
        if name == "port":
            assert ptrs == [(id(b), b.data_ptr()) for b in (
                [eng.cache["pos"], eng._last_tok, eng._active, eng._out_buf,
                 eng._prompts, eng._plens]
                + [a for layer in eng.cache["layers"]
                   for a in layer.values()])]
    assert outs["port"] == outs["reference"]
