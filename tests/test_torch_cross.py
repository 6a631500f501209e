"""The port's cross-attention family against the JAX package's, on the CPU:
the encoder-decoder (seamless-m4t) and the gated vision decoder
(llama-3.2-vision), at their SMOKE widths in float32.

The same weights go to both packages: the JAX package's ``init_params``
tree with the zero-initialized norms and the zero cross-attention gates
redrawn from a numpy seed (at tanh(0) = 0 a gated layer would add nothing),
carried into the port by ``params_from_numpy``.  The JAX side runs its
``dot`` and ``chunked`` impls (no Pallas kernel).  Tolerances: logits and
features at LOGIT_ATOL (1e-4 absolute, tests/test_torch_families.py's), the
layer functions at 1e-6 (of the largest magnitude for the MLP), gradients
within GRAD_RTOL (2e-4, the fp32 tolerance of tests/test_kernels.py) of
each leaf's largest magnitude; the front-end stubs, the configs, the
parameter counts and the served tokens exactly.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from repro.configs import registry as jregistry
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.serving import DisaggregatedEngineLoop as JDisagg
from repro.serving import EngineLoop as JEngineLoop
from repro.serving import synthetic_workload as j_workload
from repro_torch.configs import registry as pregistry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.serving import (DisaggregatedEngineLoop, EngineLoop, KVPool,
                                 SlotEngine, api)
from repro_torch.serving.request import synthetic_workload
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
GRAD_RTOL = 2e-4
ARCHS = ["seamless_m4t_medium", "llama32_vision_90b"]
B, S, T_ENC = 2, 8, 12
_REDRAWN = ("final_norm", "enc_final_norm", "gate_attn", "gate_mlp")
# the JAX package's serving test config with cross-attention
# (tests/test_driver.py), in float32 so the two frameworks' greedy tokens
# are comparable
CROSS = dict(name="driver-xattn", n_layers=4, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab=64, cross_attn_every=2,
             frontend="vision", img_seq=4, attention_impl="dot")


def _modules(arch):
    return (importlib.import_module(f"repro.configs.{arch}"),
            importlib.import_module(f"repro_torch.configs.{arch}"))


def _weights(jcfg, seed=0):
    """The JAX package's init (numpy leaves), norms and gates redrawn."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))

    def redraw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name in _REDRAWN:
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, tree)


class Family:
    """One SMOKE config in both packages (float32) and its shared weights."""

    def __init__(self, arch):
        jmod, pmod = _modules(arch)
        self.jcfg = dataclasses.replace(jmod.SMOKE, compute_dtype=jnp.float32,
                                        remat=False)
        self.pcfg = dataclasses.replace(pmod.SMOKE,
                                        compute_dtype=torch.float32)
        tree = _weights(self.jcfg)
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.pparams = params_from_numpy(self.pcfg, tree, device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.pcfg.vocab, (B, S)).astype(
            np.int32)
        self.labels = rng.integers(0, self.pcfg.vocab, (B, S)).astype(
            np.int32)
        t = T_ENC if self.pcfg.encoder_decoder else self.pcfg.img_seq
        self.feats = rng.standard_normal((B, t, self.pcfg.d_model)).astype(
            np.float32)

    def extras(self, lib):
        key = "enc_inputs" if self.pcfg.encoder_decoder else "img_embeds"
        conv = torch.from_numpy if lib is PT else jnp.asarray
        return {key: conv(self.feats)}


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return Family(request.param)


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ layers
def test_layernorm_and_gelu_mlp_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in "wb")
    _close(players.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b)),
           jlayers.layernorm(x, w, b), 1e-6)
    w_in = rng.standard_normal((16, 24)).astype(np.float32)
    w_out = rng.standard_normal((24, 16)).astype(np.float32)
    b_in = rng.standard_normal(24).astype(np.float32)
    b_out = rng.standard_normal(16).astype(np.float32)
    t = torch.from_numpy
    for biases in ((b_in, b_out), (None, None)):
        got = players.gelu_mlp(
            t(x), t(w_in), None if biases[0] is None else t(biases[0]),
            t(w_out), None if biases[1] is None else t(biases[1]),
            torch.float32)
        want = jlayers.gelu_mlp(x, w_in, biases[0], w_out, biases[1],
                                jnp.float32)
        _close(got, want, 1e-6 * float(np.abs(want).max()))


# ------------------------------------------------------ configs and counts
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_the_reference(arch):
    """registry.get gives the JAX package's configs field by field (dtypes
    by name; the JAX-only sharding knobs left out), and count_params and
    count_active_params agree exactly for CONFIG and SMOKE."""
    got, want = pregistry.get(arch), jregistry.get(arch)
    assert (got.name, got.family, got.lr_schedule) == (
        want.name, want.family, want.lr_schedule)
    for pc, jc in ((got.config, want.config), (got.smoke, want.smoke)):
        for f in dataclasses.fields(pc):
            a, b = getattr(pc, f.name), getattr(jc, f.name)
            if f.name.endswith("_dtype"):
                a, b = str(a).split(".")[-1], jnp.dtype(b).name
            assert a == b, f.name
        assert PT.count_params(pc) == JT.count_params(jc)
        assert PT.count_active_params(pc) == JT.count_active_params(jc)
    n = sum(t.numel() for _, t in tree_paths(
        PT.init_params(got.smoke, device="cpu")))
    jn = sum(a.size for a in jax.tree.leaves(
        JT.init_params(jax.random.PRNGKey(0), want.smoke)))
    assert n == jn


# ---------------------------------------------------------------- forward
def test_encode_equals_the_reference():
    f = Family("seamless_m4t_medium")
    got = PT.encode(f.pparams, f.pcfg, torch.from_numpy(f.feats))
    want = JT.encode(f.jparams, f.jcfg, jnp.asarray(f.feats))
    assert got.shape == (B, T_ENC, f.pcfg.d_model)
    _close(got, want)


def test_forward_logits_and_cross_equal_the_reference(fam):
    got, cache = PT.forward(fam.pparams, fam.pcfg, torch.from_numpy(
        fam.tokens), emit_cache=True, **fam.extras(PT))
    want, jcache = JT.forward(fam.jparams, fam.jcfg, jnp.asarray(fam.tokens),
                              emit_cache=True, **fam.extras(JT))
    _close(got, want)
    _close(cache["cross"], jcache["cross"])
    jstate = state_from_numpy(fam.pcfg, jax.tree.map(np.asarray, jcache),
                              device="cpu")
    for layer, jlayer in zip(cache["layers"], jstate["layers"]):
        assert layer.keys() == jlayer.keys()
        for name in layer:
            _close(layer[name], jlayer[name].numpy())


def test_forward_needs_its_features(fam):
    with pytest.raises(ValueError, match="needs"):
        PT.forward(fam.pparams, fam.pcfg, torch.from_numpy(fam.tokens))


def test_decode_steps_from_a_prefill_equal_the_reference(fam):
    """Prefill S tokens, then three greedy decode steps on the dense cache
    of S + 3 positions, whose cross rows are the prefill's features; the
    JAX package's filled cache comes into the port through
    state_from_numpy."""
    _, jpre = JT.forward(fam.jparams, fam.jcfg, jnp.asarray(fam.tokens),
                         emit_cache=True, **fam.extras(JT))
    jcache = JT.init_cache(fam.jcfg, B, S + 3)

    def fill(init, pre):
        if getattr(init, "ndim", 0) < 4:
            return init                              # xattn placeholders
        return init.at[..., :S, :].set(pre)

    jcache = dict(jcache, layers=jax.tree.map(fill, jcache["layers"],
                                              jpre["layers"]),
                  pos=jpre["pos"], cross=jpre["cross"])
    cache = state_from_numpy(fam.pcfg, jax.tree.map(np.asarray, jcache),
                             device="cpu")
    tok = fam.tokens[:, -1:]
    for _ in range(3):
        want, jcache = JT.decode_step(fam.jparams, fam.jcfg, jcache,
                                      jnp.asarray(tok))
        got, cache = PT.decode_step(fam.pparams, fam.pcfg, cache,
                                    torch.from_numpy(tok))
        _close(got, want)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1), np.int32)
        assert np.array_equal(got[:, -1:].argmax(-1).numpy(), tok)
    assert int(cache["pos"]) == int(jcache["pos"]) == S + 3


def test_paged_and_multi_steps_carry_the_cross_rows(fam):
    """The paged slot step equals the dense slot step bitwise with cross
    rows in both caches; for the encoder-decoder the verify's window equals
    that many single steps bitwise."""
    cfg, p = fam.pcfg, fam.pparams
    rows = torch.from_numpy(fam.feats)
    dense = PT.init_slot_cache(cfg, B, 16, device="cpu")
    paged = PT.init_slot_cache_paged(cfg, B, 16, block_size=4, device="cpu")
    paged["block_tables"].copy_(torch.arange(8, dtype=torch.int32)
                                .reshape(B, 4))
    for c in (dense, paged):
        c["cross"] = c["cross"][:, :rows.shape[1]].clone()
        c["cross"].copy_(rows)
    active = torch.tensor([True, True])
    seq = torch.from_numpy(fam.tokens)
    for i in range(5):
        a, _ = PT.decode_step_slots(p, cfg, dense, seq[:, i:i + 1], active)
        b, _ = PT.decode_step_slots_paged(p, cfg, paged, seq[:, i:i + 1],
                                          active, max_seq=16)
        assert torch.equal(a, b)
    if "xattn" in cfg.layer_types():
        with pytest.raises(ValueError, match="all-attention"):
            PT.decode_multi_step_slots_paged(p, cfg, paged, seq[:, 5:8],
                                             active, max_seq=16)
        return
    multi = {k: v.clone() if torch.is_tensor(v) else
             [{n: a.clone() for n, a in layer.items()} for layer in v]
             for k, v in paged.items()}
    logits, _ = PT.decode_multi_step_slots_paged(p, cfg, multi, seq[:, 5:8],
                                                 active, max_seq=16)
    singles = [PT.decode_step_slots_paged(p, cfg, paged, seq[:, i:i + 1],
                                          active, max_seq=16)[0]
               for i in range(5, 8)]
    assert torch.equal(logits, torch.cat(singles, dim=1))


# --------------------------------------------------------------- training
def test_loss_and_every_gradient_leaf_equal_the_reference(fam):
    batch = {"tokens": fam.tokens, "labels": fam.labels}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update(fam.extras(JT))
    want_loss, want = jax.value_and_grad(JT.loss_fn)(fam.jparams, fam.jcfg,
                                                     jbatch)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pbatch.update(fam.extras(PT))
    loss, grads = loss_and_grads(fam.pparams, fam.pcfg, pbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = params_from_numpy(fam.pcfg, jax.tree.map(np.asarray, want),
                             device="cpu")
    gpaths, wpaths = tree_paths(grads), tree_paths(want)
    assert [p for p, _ in gpaths] == [p for p, _ in wpaths]
    for (path, g), (_, w) in zip(gpaths, wpaths):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()),
                                   err_msg="/".join(path))
    # the gates and the encoder are reached
    names = {p[-1] for p, g in gpaths if float(g.abs().max()) > 0}
    assert {"gate_attn", "gate_mlp"} <= names or "enc_final_norm" in names


def test_decay_mask_follows_the_reference_layout(fam):
    """A leaf decays where the JAX package's (stacked) leaf has ndim >= 2:
    every leaf of a stacked layer but the scalar gates, every encoder
    leaf, no final norm.  The JAX package's rule comes into the port's
    layout as a tree of 1.0/0.0 fills through params_from_numpy."""
    flags = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2),
                                           np.float32), _weights(fam.jcfg))
    want = tree_paths(params_from_numpy(fam.pcfg, flags, device="cpu"))
    got = tree_paths(PT.decay_mask(fam.pcfg))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [d for _, d in got] == [bool(w.flatten()[0]) for _, w in want]


@pytest.mark.parametrize("s, t, chunk", [(6, 11, 4), (9, 5, 8)])
def test_chunked_backward_non_causal_s_ne_t(s, t, chunk):
    """ChunkedAttention's dq, dk and dv, unmasked with S != T (a short last
    key chunk), against dot attention's autograd, GQA group 2."""
    rng = np.random.default_rng(s * t)
    q = rng.standard_normal((2, 4, s, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, t, 8)).astype(np.float32)
            for _ in "kv")
    dout = rng.standard_normal((2, 4, s, 8)).astype(np.float32)

    def run(impl):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = pattn.attend(*leaves, impl=impl, causal=False, kv_chunk=chunk)
        out.backward(torch.from_numpy(dout))
        return out.detach(), [x.grad for x in leaves]

    out, grads = run("chunked")
    want_out, want = run("dot")
    _close(out, want_out.numpy(), GRAD_RTOL * float(want_out.abs().max()))
    for name, g, w in zip("qkv", grads, want):
        assert g.shape == w.shape, name
        _close(g, w.numpy(), GRAD_RTOL * float(w.abs().max()))


def test_hopper_non_causal_plain_version_on_the_cpu():
    """On a CPU tensor the flash wrapper takes its plain version, which for
    an unmasked S != T call is dot attention's function."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 13, 8)).astype(
        np.float32))
    with torch.no_grad():
        got = pattn.attend(q, k, k, impl="hopper", causal=False)
        want = pattn.attend(q, k, k, impl="dot", causal=False)
    _close(got, want.numpy(), 1e-6)


# -------------------------------------------------------------- data stubs
@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_frontend_stubs_equal_the_reference_bitwise(frontend):
    fields = dict(global_batch=2, seq_len=6, vocab=32, seed=4,
                  frontend=frontend, d_model=8, img_seq=5, enc_len=7)
    got, want = SyntheticLM(DataConfig(**fields), device="cpu"), \
        JSyntheticLM(JDataConfig(**fields))
    for _ in range(2):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


# ---------------------------------------------------------------- serving
def _cfgs(**fields):
    return (JT.ModelConfig(**CROSS, compute_dtype=jnp.float32, remat=False,
                           **fields),
            PT.ModelConfig(**CROSS, compute_dtype=torch.float32, **fields))


def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def test_export_import_migrates_cross_rows():
    _, pc = _cfgs()
    src = SlotEngine(pc, PT.init_params(pc, device="cpu"),
                     KVPool(2, 8), device="cpu")
    dst = SlotEngine(pc, PT.init_params(pc, device="cpu"),
                     KVPool(3, 8), device="cpu")
    src.cache["cross"][1] = 7.0
    state = src.export_slot(1)
    assert state["cross"] is not None
    src.cache["cross"][1] = 3.0               # the snapshot is a copy
    dst.import_slot(0, state, dest_blocks=[0])
    got = dst.cache["cross"]
    assert bool((got[0] == 7.0).all()) and bool((got[1:] == 0.0).all())
    assert SlotEngine.state_nbytes(state) == SlotEngine.state_nbytes(
        {k: v for k, v in state.items() if k != "cross"}) + 4 * 4 * 32


def test_import_slot_rejects_cross_config_mismatch_both_ways():
    jc, pc = _cfgs()
    plain_cfg = dataclasses.replace(pc, cross_attn_every=0, frontend="none")
    src = SlotEngine(pc, PT.init_params(pc, device="cpu"), KVPool(2, 8),
                     device="cpu")
    state = src.export_slot(0)
    state["cross"] = None
    dst = SlotEngine(pc, PT.init_params(pc, device="cpu"), KVPool(2, 8),
                     device="cpu")
    with pytest.raises(ValueError) as got:
        dst.import_slot(0, state, dest_blocks=[0])
    jsrc = JEngineLoop(jc, JT.init_params(jax.random.PRNGKey(0), jc),
                       n_slots=2, max_seq=8, kv_layout="dense").engine
    jstate = jsrc.export_slot(0)
    jstate["cross"] = None
    with pytest.raises(ValueError) as want:
        JEngineLoop(jc, None, n_slots=2, max_seq=8,
                    kv_layout="dense").engine.import_slot(0, jstate)
    assert str(got.value) == str(want.value)
    plain = SlotEngine(plain_cfg, PT.init_params(plain_cfg, device="cpu"),
                       KVPool(2, 8), device="cpu")
    with pytest.raises(ValueError) as got:
        plain.import_slot(0, src.export_slot(0), dest_blocks=[0])
    jplain_cfg = dataclasses.replace(jc, cross_attn_every=0, frontend="none")
    with pytest.raises(ValueError) as want:
        JEngineLoop(jplain_cfg, None, n_slots=2, max_seq=8,
                    kv_layout="dense").engine.import_slot(
                        0, jsrc.export_slot(0))
    assert str(got.value) == str(want.value)


def test_disaggregated_cross_config_equals_colocated_and_the_reference():
    """The JAX package's CROSS serving config (nonzero gates, each slot's
    cross row its own features): the port's disaggregated loop gives its
    colocated loop's tokens bit for bit (the hand-off carries the rows),
    and both give the JAX package's EngineLoop's greedy tokens."""
    jc, pc = _cfgs()
    tree = _weights(jc, seed=1)
    rows = np.random.default_rng(2).standard_normal(
        (2, jc.img_seq, jc.d_model)).astype(np.float32)

    def workload(make):
        return make(4, rate=1e9, vocab=jc.vocab, prompt_lens=(4,),
                    gen_lens=(4,), seed=3)

    jloop = JEngineLoop(jc, jax.tree.map(jnp.asarray, tree), n_slots=2,
                        max_seq=8)
    jloop.engine.cache = dict(jloop.engine.cache, cross=jnp.asarray(rows))
    jreqs = workload(j_workload)
    jloop.run(jreqs, now_fn=_clock())
    want = {r.rid: [int(t) for t in r.output] for r in jreqs}
    params = params_from_numpy(pc, tree, device="cpu")
    colo = EngineLoop(pc, params, n_slots=2, max_seq=8, device="cpu")
    colo.engine.cache["cross"].copy_(torch.from_numpy(rows))
    dis = DisaggregatedEngineLoop(pc, params, n_prefill_slots=2,
                                  n_decode_slots=2, max_seq=8, device="cpu")
    dis.prefill.cache["cross"].copy_(torch.from_numpy(rows))
    outs = []
    for loop in (colo, dis):
        reqs = workload(synthetic_workload)
        m = loop.run(reqs, now_fn=_clock())
        assert m.n_done == 4
        outs.append({r.rid: [int(t) for t in r.output] for r in reqs})
    # the decode engine's own rows are zeros: the hand-off carried them
    assert outs[0] == outs[1] == want
    assert not bool(dis.decode.cache["cross"].eq(0).all())
    jdis = JDisagg(jc, jax.tree.map(jnp.asarray, tree), n_prefill_slots=2,
                   n_decode_slots=2, max_seq=8)
    jdis.prefill.cache = dict(jdis.prefill.cache, cross=jnp.asarray(rows))
    jreqs = workload(j_workload)
    jdis.run(jreqs, now_fn=_clock())
    assert {r.rid: [int(t) for t in r.output] for r in jreqs} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_the_cross_archs_with_the_reference_words(arch):
    def message(lib, **kw):
        o = lib.ServeOptions()
        o.workload.arch = arch
        with pytest.raises(ValueError) as exc:
            lib.serve(o, **kw)
        return str(exc.value)

    assert message(api, device="cpu") == message(japi)
