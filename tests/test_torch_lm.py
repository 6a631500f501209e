"""The port's transformer (qwen2's dense all-attention path) against the JAX
package's, on the CPU at SMOKE width.

The same weights go to both packages: the JAX package's ``init_params`` tree
(with the zero-initialized norms and biases redrawn from a numpy seed, so
that they matter) as numpy arrays, carried into the port by
``params_from_numpy``.  Compute runs in float32, where the two frameworks
differ only in summation order: logits are held at 2e-5 absolute (about 20x
the 1e-6 measured on these inputs), and greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_1_5b as jcfgs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro_torch.configs import qwen2_1_5b as pcfgs
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

LOGIT_ATOL = 2e-5
JCFG = dataclasses.replace(jcfgs.SMOKE, compute_dtype=jnp.float32)
PCFG = dataclasses.replace(pcfgs.SMOKE, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port tree) of the same float32 values."""
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


def _close(got: torch.Tensor, want, atol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ layers
def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) * 37
    _close(players.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _close(players.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


@pytest.mark.parametrize("impl", ["dot", "chunked", "hopper"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_impls_match(impl, window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, h, 19, 16)).astype(np.float32)
               for h in (6, 2, 2))
    want = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window)
    got = pattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), impl=impl, causal=True,
                       window=window, kv_chunk=8)
    _close(got, want, 1e-5)


def test_decode_attention_contracts_in_cache_dtype():
    # bf16 cache: q is rounded to bf16 before the fp32-accumulated
    # contraction in both packages, so they agree to fp32 rounding
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 6, 1, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 2, 12, 16)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 5, 11], np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), pos=jnp.asarray(pos))
    got = pattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc).bfloat16(),
        torch.from_numpy(vc).bfloat16(), pos=torch.from_numpy(pos))
    _close(got, want, 1e-5)


# ------------------------------------------------------------------ model
def test_count_params_matches_exactly():
    from repro.configs import deepseek_coder_33b, minicpm_2b
    assert PT.count_params(pcfgs.CONFIG) == JT.count_params(jcfgs.CONFIG)
    assert PT.count_params(pcfgs.SMOKE) == JT.count_params(jcfgs.SMOKE)
    assert PT.count_params(pcfgs.CONFIG) == 1_543_626_752
    for mod in (deepseek_coder_33b, minicpm_2b):
        for jc in (mod.CONFIG, mod.SMOKE):
            fields = {f.name: getattr(jc, f.name)
                      for f in dataclasses.fields(PT.ModelConfig)
                      if not f.name.endswith("dtype")}
            assert (PT.count_params(PT.ModelConfig(**fields))
                    == JT.count_params(jc)), jc.name


def test_init_params_has_the_counted_shapes():
    # count_params leaves the norm weights out, as the JAX package's does
    params = PT.init_params(PCFG, 0, device="cpu")
    n = sum(t.numel() for t in _leaves(params))
    norms = (2 * PCFG.n_layers + 1) * PCFG.d_model
    assert n - norms == PT.count_params(PCFG)
    assert PT.init_params(PCFG, 0, device="cpu")["embed"].equal(
        params["embed"])                              # seeded


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_params_from_numpy_checks_shapes(weights):
    tree = jax.tree.map(np.asarray, weights[0])
    tree["final_norm"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(PCFG, tree, device="cpu")


@pytest.mark.parametrize("impl", ["dot", "chunked", "hopper"])
def test_forward_logits_and_cache_match(weights, impl):
    jp, pp = weights
    tokens = np.random.default_rng(4).integers(0, JCFG.vocab, size=(2, 21),
                                               dtype=np.int32)
    want, jcache = JT.forward(jp, JCFG, jnp.asarray(tokens), emit_cache=True)
    cfg = dataclasses.replace(PCFG, attention_impl=impl, attn_chunk=8)
    got, cache = PT.forward(pp, cfg, torch.from_numpy(tokens),
                            emit_cache=True)
    assert got.shape == (2, 21, JCFG.vocab)
    _close(got, want, LOGIT_ATOL)
    # the JAX cache stacks layers: (n_layers, B, HK, S, hd)
    jk = np.asarray(jcache["layers"][0][0]["k"])
    for i, layer in enumerate(cache["layers"]):
        _close(layer["k"], jk[i], 1e-5)
    assert int(cache["pos"]) == 21


def test_windowed_prefill_cache_is_a_rolling_buffer(weights):
    """attn_window 4 over 10 tokens: the JAX package keeps the last four
    positions, position p in slot p % 4 (slots hold 8, 9, 6, 7), the layout
    its windowed decode step reads; the port's cache is the same."""
    jp, pp = weights
    tokens = np.random.default_rng(6).integers(0, JCFG.vocab, size=(1, 10),
                                               dtype=np.int32)
    jcfg = dataclasses.replace(JCFG, attn_window=4)
    pcfg = dataclasses.replace(PCFG, attn_window=4)
    _, jcache = JT.forward(jp, jcfg, jnp.asarray(tokens), emit_cache=True)
    _, cache = PT.forward(pp, pcfg, torch.from_numpy(tokens),
                          emit_cache=True)
    # layer 0 within 2e-6 (the two frameworks' rope differs by up to
    # 1.2e-6 here); later layers read attention outputs, whose summation
    # order differs too, at the 1e-5 of test_forward_logits_and_cache_match
    for name in ("k", "v"):
        want = np.asarray(jcache["layers"][0][0][name])
        for i, layer in enumerate(cache["layers"]):
            assert tuple(layer[name].shape) == want[i].shape == (1, 2, 4, 16)
            _close(layer[name], want[i], 2e-6 if i == 0 else 1e-5)
    # layer 0's K and V come before any attention, so the unwindowed cache
    # holds them at every position: slot s holds position (8, 9, 6, 7)[s]
    _, full = PT.forward(pp, PCFG, torch.from_numpy(tokens), emit_cache=True)
    for slot, p in enumerate((8, 9, 6, 7)):
        for name in ("k", "v"):
            assert torch.equal(cache["layers"][0][name][:, :, slot],
                               full["layers"][0][name][:, :, p])
    assert int(cache["pos"]) == 10


def test_one_paged_decode_step_matches(weights):
    """One block-paged slot step with an inactive slot, shuffled pages and
    a position on a page boundary: logits, positions and the written
    pages agree with the JAX package's step."""
    jp, pp = weights
    rng = np.random.default_rng(5)
    n_slots, max_seq, bs = 3, 24, 8
    jcache = JT.init_slot_cache_paged(JCFG, n_slots, max_seq, block_size=bs)
    pcache = PT.init_slot_cache_paged(PCFG, n_slots, max_seq, block_size=bs,
                                      device="cpu")
    # fill every arena with the same random KV, then shuffle the tables
    blocks, rem = jcache["layers"]
    tb = blocks[0]["k"].shape[1]
    kv = rng.normal(size=(2, PCFG.n_layers) + blocks[0]["k"].shape[1:]
                    ).astype(np.float32)
    jcache["layers"] = ({"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
                        ), rem
    for i, layer in enumerate(pcache["layers"]):
        layer["k"].copy_(torch.from_numpy(kv[0, i]))
        layer["v"].copy_(torch.from_numpy(kv[1, i]))
    tables = rng.permutation(tb - 1)[:n_slots * 3].reshape(n_slots, 3)
    pos = np.array([7, 16, 11], np.int32)
    active = np.array([True, True, False])
    tokens = rng.integers(0, JCFG.vocab, size=(n_slots, 1), dtype=np.int32)
    jcache["block_tables"] = jnp.asarray(tables, jnp.int32)
    jcache["pos"] = jnp.asarray(pos)
    pcache["block_tables"] = torch.from_numpy(tables.astype(np.int32))
    pcache["pos"] = torch.from_numpy(pos.copy())

    want, jnew = JT.decode_step_slots_paged(jp, JCFG, jcache,
                                            jnp.asarray(tokens),
                                            jnp.asarray(active),
                                            max_seq=max_seq)
    got, pnew = PT.decode_step_slots_paged(pp, PCFG, pcache,
                                           torch.from_numpy(tokens),
                                           torch.from_numpy(active),
                                           max_seq=max_seq)
    _close(got[:2], np.asarray(want)[:2], LOGIT_ATOL)    # inactive: unused
    assert pnew["pos"].tolist() == np.asarray(jnew["pos"]).tolist() \
        == [8, 17, 11]
    jk = np.asarray(jnew["layers"][0][0]["k"])
    for i, layer in enumerate(pnew["layers"]):
        # every live page (all but the trash page) agrees
        _close(layer["k"][:-1], jk[i, :-1], 1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_params(PCFG)
    assert PT.init_params(PCFG, device="cpu")["embed"].device.type == "cpu"


def test_unported_layer_types_are_refused():
    """The name is historical: every layer type is ported now (recurrent,
    Mamba and MoE layers, and cross-attention: a ``xattn`` layer, the
    encoder-decoder and the vision front end), so each of these configs
    counts its parameters as the JAX package does, its parameter tree
    holds that many, and its cache carries the JAX package's cross rows:
    (batch, max_seq, d) for an encoder-decoder, (batch, img_seq, d) for a
    vision config, none for a decoder-only one."""
    hybrid = dataclasses.replace(PCFG, block_pattern=("rec", "attn"))
    assert PT.count_params(hybrid) > 0
    fields = (dict(block_pattern=("attn", "xattn")),
              dict(cross_attn_every=2),
              dict(encoder_decoder=True, enc_layers=2),
              dict(frontend="vision", img_seq=5))
    for f in fields:
        cfg = dataclasses.replace(PCFG, **f)
        jcfg = dataclasses.replace(JCFG, **f)
        assert PT.count_params(cfg) == JT.count_params(jcfg)
        n = sum(t.numel() for t in jax.tree.leaves(
            PT.init_params(cfg, device="cpu"),
            is_leaf=lambda x: isinstance(x, torch.Tensor)))
        jn = sum(a.size for a in jax.tree.leaves(
            JT.init_params(jax.random.PRNGKey(0), jcfg)))
        assert n == jn
        cache = PT.init_cache(cfg, 1, 8, device="cpu")
        jcross = JT.init_cache(jcfg, 1, 8)["cross"]
        if jcross is None:
            assert "cross" not in cache
        else:
            assert tuple(cache["cross"].shape) == jcross.shape
