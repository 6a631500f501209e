"""The MoE, recurrent and other decoder configs of the port against the JAX
package's, on the CPU at SMOKE width in float32.

Parametrised over the seven SMOKE configs (mixtral and phi3.5-MoE, the
Mamba-1 falcon-mamba, the RG-LRU hybrid recurrentgemma, and the dense
deepseek-coder, granite and minicpm), with the JAX package's weights
(norms and zero biases redrawn from a numpy seed, so that they matter)
carried in by ``params_from_numpy``:

* the configs equal the JAX package's field for field, and the converted
  parameters its interleaved layer stacks leaf for leaf;
* ``forward`` logits and prefill caches, ``decode_step_slots`` and
  ``decode_step_slots_paged`` logits and states (held through
  ``state_from_numpy``) agree at LOGIT_ATOL, and greedy tokens are equal;
* ``count_params`` (all eight decoder-only configs) and
  ``count_active_params``, ``handoff_payload_bytes`` and
  ``phase_network_spec`` equal the JAX package's exactly;
* inside the port, bit for bit: paged == dense (configs without a window),
  continuous == static, a slot rebound after another tenant gives a fresh
  slot's tokens, and disaggregated == colocated (falcon-mamba,
  recurrentgemma);
* ``serve()`` of phi3.5-MoE and falcon-mamba gives the JAX package's serve
  tokens on the same weights, and the refusals keep its words.

LOGIT_ATOL is 1e-4: the largest difference measured on these inputs is
~1e-5 (MoE routing and the two scans sum in other orders), against 2e-5
for the dense qwen2 path (tests/test_torch_lm.py).  The conv states, which
both packages store in bfloat16, are held within one bfloat16 step
(CONV_RTOL, 2^-7 relative): a few layers deep, the two frameworks' fp32
inputs to that rounding differ by ~1e-6 and can fall on either side of a
rounding boundary (falcon-mamba's fourth layer does here).  A decode step
reads its conv state back, so such a step propagates: falcon-mamba's decode
logits and states are held at MAMBA_DECODE_ATOL, 5e-3 (3x the 1.6e-3
measured over 20 steps); its greedy tokens are still equal.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serving import EngineLoop as JEngineLoop
from repro.serving import api as japi
from repro.serving import batcher as jbatcher
from repro.serving import placement as jplace
from repro.serving.speculative import validate_speculation as jvalidate
from repro_torch.configs import registry as pregistry
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.serving import DisaggregatedEngineLoop, EngineLoop, api
from repro_torch.serving import batcher as pbatcher
from repro_torch.serving import placement as pplace
from repro_torch.serving.api import Server
from repro_torch.serving.request import synthetic_workload
from repro_torch.serving.speculative import validate_speculation

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
CONV_RTOL = 2.0 ** -7            # one bfloat16 step: the stored conv states
MAMBA_DECODE_ATOL = 5e-3         # decode logits behind bf16 conv states
ARCHS = ["mixtral_8x7b", "phi35_moe", "falcon_mamba_7b", "recurrentgemma_2b",
         "deepseek_coder_33b", "granite_34b", "minicpm_2b"]
UNWINDOWED = [a for a in ARCHS
              if a not in ("mixtral_8x7b", "recurrentgemma_2b")]
N_SLOTS, MAX_SEQ, PAGE = 3, 24, 4
_REDRAWN = ("final_norm", "bq", "bk", "bv", "conv_b", "b_a", "b_i")


def _modules(arch):
    return (importlib.import_module(f"repro.configs.{arch}"),
            importlib.import_module(f"repro_torch.configs.{arch}"))


class Family:
    """One SMOKE config in both packages, its shared weights and the JAX
    package's jitted steps."""

    def __init__(self, arch):
        jmod, pmod = _modules(arch)
        self.arch = arch
        self.jcfg = dataclasses.replace(jmod.SMOKE, compute_dtype=jnp.float32)
        self.pcfg = dataclasses.replace(pmod.SMOKE,
                                        compute_dtype=torch.float32)
        rng = np.random.default_rng(0)
        tree = jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(0), self.jcfg))

        def redraw(path, a):
            name = str(getattr(path[-1], "key", ""))
            if name.startswith("ln") or name in _REDRAWN:
                return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a

        self.tree = jax.tree_util.tree_map_with_path(redraw, tree)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        self.pparams = params_from_numpy(self.pcfg, self.tree, device="cpu")
        jcfg = self.jcfg
        self.jforward = jax.jit(lambda p, t: JT.forward(p, jcfg, t,
                                                        emit_cache=True))
        self.jslots = jax.jit(lambda p, c, t, a: JT.decode_step_slots(
            p, jcfg, c, t, a))
        self.jpaged = jax.jit(lambda p, c, t, a: JT.decode_step_slots_paged(
            p, jcfg, c, t, a, max_seq=MAX_SEQ))

    @property
    def decode_atol(self) -> float:
        return (MAMBA_DECODE_ATOL if "mamba" in self.pcfg.layer_types()
                else LOGIT_ATOL)

    @property
    def windowed(self) -> bool:
        return self.pcfg.attn_window is not None

    def layout(self) -> str:
        return "dense" if self.windowed else "paged"


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return Family(request.param)


def _close(got: torch.Tensor, want, rows=None, atol=LOGIT_ATOL):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _states_close(got, want, atol=None):
    """A port cache against a converted JAX package cache: float leaves at
    ``atol`` (LOGIT_ATOL unless given), the bfloat16 conv states also
    within one bfloat16 step, integer leaves exact."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    atol = atol or LOGIT_ATOL
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        if not g.is_floating_point():
            assert torch.equal(g, w), path
        elif g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=CONV_RTOL, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=path)


def _port_cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(PT.ModelConfig)}


# ---------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ["qwen2_1_5b"])
def test_configs_equal_the_reference_field_for_field(arch):
    jmod, pmod = _modules(arch)
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for name in ("CONFIG", "SMOKE"):
        got = _port_cfg_fields(getattr(pmod, name))
        want = getattr(jmod, name)
        for field, value in got.items():
            ref = getattr(want, field)
            assert value == dtypes.get(ref, ref), (arch, name, field)
    assert pmod.LR_SCHEDULE == jmod.LR_SCHEDULE
    spec = pregistry.get(arch)
    assert spec.config == pmod.CONFIG and spec.smoke == pmod.SMOKE


def test_params_convert_interleaving_the_layer_stacks(fam):
    cfg, unit = fam.pcfg, fam.pcfg.pattern_unit()
    blocks, rem = fam.tree["decoder"]["blocks"], fam.tree["decoder"]["rem"]
    assert len(fam.pparams["layers"]) == cfg.n_layers
    for i, (btype, layer) in enumerate(zip(cfg.layer_types(),
                                           fam.pparams["layers"])):
        if i < cfg.n_super * len(unit):
            src = jax.tree.map(lambda a, i=i: a[i // len(unit)],
                               blocks[i % len(unit)])
        else:
            src = rem[i - cfg.n_super * len(unit)]
        assert btype in layer or btype == "attn"
        want = dict(_leaves(dict(src)))
        assert sorted(dict(_leaves(layer))) == sorted(want)
        for path, got in _leaves(layer):
            np.testing.assert_array_equal(got.numpy(), want[path],
                                          err_msg=path)
    if cfg.n_experts:
        assert fam.pparams["layers"][0]["mlp"]["w_gate"].shape == (
            cfg.n_experts, cfg.d_model, cfg.d_ff)
    n = sum(t.numel() for _, t in _leaves(fam.pparams))
    assert n == sum(a.size for a in jax.tree.leaves(fam.tree))
    init = PT.init_params(cfg, 0, device="cpu")
    assert sorted((p, t.shape) for p, t in _leaves(init)) == sorted(
        (p, t.shape) for p, t in _leaves(fam.pparams))


# ---------------------------------------------------------------------
# forward and decode against the JAX package
# ---------------------------------------------------------------------
def test_forward_logits_and_prefill_cache_match(fam):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, fam.pcfg.vocab, size=(2, 32), dtype=np.int32)
    want, wcache = fam.jforward(fam.jparams, jnp.asarray(tokens))
    got, gcache = PT.forward(fam.pparams, fam.pcfg, torch.from_numpy(tokens),
                             emit_cache=True)
    _close(got, want)
    wcache = jax.tree.map(np.asarray, {"layers": wcache["layers"],
                                       "pos": wcache["pos"]})
    _states_close(gcache, state_from_numpy(fam.pcfg, wcache, device="cpu"))


def _random_steps(fam, step_j, step_p, jcache, pcache, n_steps, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        t = rng.integers(0, fam.pcfg.vocab, size=(N_SLOTS, 1),
                         dtype=np.int32)
        active = rng.random(N_SLOTS) < 0.8
        want, jcache = step_j(fam.jparams, jcache, jnp.asarray(t),
                              jnp.asarray(active))
        got, pcache = step_p(fam.pparams, fam.pcfg, pcache,
                             torch.from_numpy(t), torch.from_numpy(active))
        _close(got, want, rows=active, atol=fam.decode_atol)
    return jcache, pcache


def test_decode_step_slots_matches(fam):
    """20 steps under a random active mask, past the SMOKE window of 16."""
    jcache = JT.init_slot_cache(fam.jcfg, N_SLOTS, MAX_SEQ)
    pcache = PT.init_slot_cache(fam.pcfg, N_SLOTS, MAX_SEQ, device="cpu")
    jcache, pcache = _random_steps(fam, fam.jslots, PT.decode_step_slots,
                                   jcache, pcache, 20, seed=2)
    jcache = jax.tree.map(np.asarray, {"layers": jcache["layers"],
                                       "pos": jcache["pos"]})
    _states_close(pcache, state_from_numpy(fam.pcfg, jcache, device="cpu"),
                  atol=fam.decode_atol)


def test_decode_step_slots_paged_matches(fam):
    if fam.windowed:
        # neither package pages a rolling buffer
        for lib, cfg in ((JT, fam.jcfg), (PT, fam.pcfg)):
            with pytest.raises(ValueError, match="sliding-window"):
                lib.init_slot_cache_paged(cfg, N_SLOTS, MAX_SEQ)
        return
    tables = np.arange(N_SLOTS * MAX_SEQ // PAGE, dtype=np.int32)[::-1] \
        .reshape(N_SLOTS, -1)
    jcache = JT.init_slot_cache_paged(fam.jcfg, N_SLOTS, MAX_SEQ,
                                      block_size=PAGE)
    jcache["block_tables"] = jnp.asarray(tables)
    pcache = PT.init_slot_cache_paged(fam.pcfg, N_SLOTS, MAX_SEQ,
                                      block_size=PAGE, device="cpu")
    pcache["block_tables"].copy_(torch.from_numpy(tables.copy()))

    def step(params, cfg, cache, t, a):
        return PT.decode_step_slots_paged(params, cfg, cache, t, a,
                                          max_seq=MAX_SEQ)

    jcache, pcache = _random_steps(fam, fam.jpaged, step, jcache, pcache,
                                   16, seed=3)
    jcache = jax.tree.map(np.asarray, {
        "layers": jcache["layers"], "pos": jcache["pos"],
        "block_tables": jcache["block_tables"]})
    _states_close(pcache, state_from_numpy(fam.pcfg, jcache, device="cpu"),
                  atol=fam.decode_atol)


def test_greedy_tokens_equal_across_frameworks(fam):
    """Prompts of 6 tokens, then 12 greedy tokens, every slot active."""
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, fam.pcfg.vocab, size=(N_SLOTS, 6),
                           dtype=np.int32)
    active = np.ones(N_SLOTS, bool)
    jcache = JT.init_slot_cache(fam.jcfg, N_SLOTS, MAX_SEQ)
    pcache = PT.init_slot_cache(fam.pcfg, N_SLOTS, MAX_SEQ, device="cpu")
    jtok = ptok = None
    jout, pout = [], []
    for i in range(6 + 12 - 1):
        jfeed = prompts[:, i:i + 1] if i < 6 else jtok
        pfeed = prompts[:, i:i + 1] if i < 6 else ptok
        jl, jcache = fam.jslots(fam.jparams, jcache, jnp.asarray(jfeed),
                                jnp.asarray(active))
        pl, pcache = PT.decode_step_slots(fam.pparams, fam.pcfg, pcache,
                                          torch.from_numpy(pfeed),
                                          torch.from_numpy(active))
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        ptok = torch.argmax(pl[:, -1], -1).to(torch.int32)[:, None].numpy()
        if i >= 5:
            jout.append(jtok)
            pout.append(ptok)
    np.testing.assert_array_equal(np.concatenate(pout, 1),
                                  np.concatenate(jout, 1))


# ---------------------------------------------------------------------
# accounting and pricing
# ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ["qwen2_1_5b"])
def test_counts_equal_the_reference(arch):
    jmod, pmod = _modules(arch)
    for name in ("CONFIG", "SMOKE"):
        pc, jc = getattr(pmod, name), getattr(jmod, name)
        assert PT.count_params(pc) == JT.count_params(jc), (arch, name)
        assert PT.count_active_params(pc) == JT.count_active_params(jc)
    if pmod.CONFIG.n_experts:
        assert (PT.count_active_params(pmod.CONFIG)
                < PT.count_params(pmod.CONFIG))


@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_bytes_and_phase_networks_equal_the_reference(arch):
    jmod, pmod = _modules(arch)
    for name in ("CONFIG", "SMOKE"):
        pc, jc = getattr(pmod, name), getattr(jmod, name)
        for kw in (dict(prompt_len=128), dict(prompt_len=64, slot_len=4096),
                   dict(prompt_len=7, dtype_bytes=4)):
            assert (pplace.handoff_payload_bytes(pc, **kw)
                    == jplace.handoff_payload_bytes(jc, **kw)), kw
        for seq, kv in ((1, 160), (128, 128)):
            got = pbatcher.phase_network_spec(pc, seq=seq, kv_len=kv)
            want = jbatcher.phase_network_spec(jc, seq=seq, kv_len=kv)
            assert got.name == want.name
            assert ([(type(s).__name__, dataclasses.astuple(s))
                     for s in got.layers]
                    == [(type(s).__name__, dataclasses.astuple(s))
                        for s in want.layers])


# ---------------------------------------------------------------------
# the port's own identities, bit for bit
# ---------------------------------------------------------------------
def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _workload(cfg, n=9, seed=11):
    return synthetic_workload(n, rate=1e9, vocab=cfg.vocab,
                              prompt_lens=(4, 8), gen_lens=(3, 6, 12),
                              seed=seed)


def _serve(fam, reqs, *, n_slots=N_SLOTS, kv_layout=None, **kw):
    loop = EngineLoop(fam.pcfg, fam.pparams, n_slots=n_slots,
                      max_seq=8 + 12, block_size=PAGE,
                      kv_layout=kv_layout or fam.layout(), device="cpu",
                      **kw)
    assert loop.run(reqs, now_fn=_clock()).n_done == len(reqs)
    return {r.rid: r.output for r in reqs}


@pytest.mark.parametrize("fam", UNWINDOWED, indirect=True)
def test_paged_equals_dense_bitwise(fam):
    """Configs without a window: a sliding-window config serves on the
    dense layout only (test_decode_step_slots_paged_matches)."""
    assert (_serve(fam, _workload(fam.pcfg), kv_layout="paged")
            == _serve(fam, _workload(fam.pcfg), kv_layout="dense"))


def test_continuous_equals_static_bitwise(fam):
    """3 slots for 9 requests against the static server in batches of one
    prompt length, padded to 3 rows (tests/test_torch_dense_cache.py)."""
    server = Server(fam.pcfg, fam.pparams, 8 + 12, device="cpu")
    reqs = _workload(fam.pcfg)
    groups = {}
    for r in reqs:
        groups.setdefault(r.prompt_len, []).append(r)
    want = {}
    for grp in groups.values():
        for i in range(0, len(grp), N_SLOTS):
            chunk = grp[i:i + N_SLOTS]
            rows = [r.prompt for r in chunk]
            rows += [rows[-1]] * (N_SLOTS - len(rows))
            toks = server.generate(torch.from_numpy(np.stack(rows)),
                                   max(r.max_new_tokens for r in chunk))
            for j, r in enumerate(chunk):
                want[r.rid] = toks[j, :r.max_new_tokens].tolist()
    assert _serve(fam, reqs) == want


def test_rebound_slot_gives_a_fresh_slots_tokens(fam):
    """One slot serves three requests in turn; each gets the tokens it
    gets alone on a fresh engine (recurrent states are zeroed on bind)."""
    reqs = _workload(fam.pcfg, n=3, seed=12)
    shared = _serve(fam, reqs, n_slots=1)
    for r in _workload(fam.pcfg, n=3, seed=12):
        assert _serve(fam, [r], n_slots=1)[r.rid] == shared[r.rid]


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_disaggregated_equals_colocated_bitwise(arch):
    fam = Family(arch)
    colocated = _serve(fam, _workload(fam.pcfg))
    for async_handoff in (True, False):
        reqs = _workload(fam.pcfg)
        dis = DisaggregatedEngineLoop(
            fam.pcfg, fam.pparams, n_prefill_slots=2, n_decode_slots=3,
            max_seq=8 + 12, block_size=PAGE, kv_layout=fam.layout(),
            async_handoff=async_handoff, device="cpu")
        m = dis.run(reqs, now_fn=_clock())
        assert m.n_done == 9 and dis.handoff.n_handoffs == 9
        assert {r.rid: r.output for r in reqs} == colocated


# ---------------------------------------------------------------------
# serve() and the refusals, against the JAX package
# ---------------------------------------------------------------------
def _opts(lib, **fields):
    o = lib.ServeOptions()
    groups = o.flat_fields()
    for name, value in dict(requests=6, prompt_len=6, gen_len=8, rate=1e9,
                            slots=3, **fields).items():
        setattr(getattr(o, groups[name]), name, value)
    return o


@pytest.mark.parametrize("arch", ["phi35_moe", "falcon_mamba_7b"])
def test_serve_matches_the_reference(arch, monkeypatch):
    fam = Family(arch)
    monkeypatch.setattr(jregistry, "get", lambda name: jregistry.ArchSpec(
        name=name, config=None, smoke=fam.jcfg))
    monkeypatch.setattr(pregistry, "get", lambda name: pregistry.ArchSpec(
        name=name, config=None, smoke=fam.pcfg))
    monkeypatch.setattr(japi, "build_params", lambda cfg, mesh: fam.jparams)
    monkeypatch.setattr(api, "build_params", lambda cfg, dev: fam.pparams)
    got = api.serve(_opts(api, arch=arch), device="cpu")
    want = japi.serve(_opts(japi, arch=arch))
    assert got.summary["requests_done"] == want.summary["requests_done"] == 6
    assert got.outputs == want.outputs
    assert [len(v) for v in got.outputs.values()] == [
        r.max_new_tokens for r in got.requests]


def _message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as exc:
        fn(*args, **kwargs)
    return str(exc.value)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_refusals_keep_the_reference_words(arch):
    jmod, pmod = _modules(arch)
    jc, pc = jmod.SMOKE, pmod.SMOKE
    # speculation: recurrent state has no multi-token verify or rollback
    got = _message(validate_speculation, pc, pc, kv_layout="paged",
                   prefix_sharing=False)
    assert got == _message(jvalidate, jc, jc, kv_layout="paged",
                           prefix_sharing=False)
    assert "all-attention target" in got
    with pytest.raises(ValueError, match="multi-token slot step"):
        PT.decode_multi_step_slots_paged(
            {}, pc, {"pos": None, "block_tables": None}, None, None,
            max_seq=8)
    # prefix sharing: the loops and serve()
    kw = dict(n_slots=2, max_seq=16, kv_layout="paged", prefix_sharing=True)
    got = _message(EngineLoop, pc, None, device="cpu", **kw)
    assert got == _message(JEngineLoop, jc, None, **kw)
    assert got == _message(DisaggregatedEngineLoop, pc, None,
                           n_prefill_slots=1, n_decode_slots=2, max_seq=16,
                           prefix_sharing=True, device="cpu")
    if pc.attn_window is None:
        opts = dict(arch=arch, prefix_sharing=True)
        assert (_message(api.serve, _opts(api, **opts), device="cpu")
                == _message(japi.serve, _opts(japi, **opts)))


@pytest.mark.parametrize("arch", ["seamless_m4t_medium",
                                  "llama32_vision_90b"])
def test_cross_attention_archs_are_refused(arch):
    """The name is historical: the two cross-attention archs are ported
    (tests/test_torch_cross.py holds them to the JAX package), so the
    registry now resolves them to the JAX package's configs, and a MoE
    config with gated cross-attention layers counts its parameters as the
    JAX package does; only serve() still refuses them, with the JAX
    package's own words (its serve is decoder-only too)."""
    jmod, pmod = _modules(arch)
    spec = pregistry.get(arch)
    assert spec.config == pmod.CONFIG and spec.smoke == pmod.SMOKE
    assert spec.config.name == jmod.CONFIG.name
    cfg = dataclasses.replace(_modules("phi35_moe")[1].SMOKE,
                              cross_attn_every=2)
    jcfg = dataclasses.replace(_modules("phi35_moe")[0].SMOKE,
                               cross_attn_every=2)
    assert PT.count_params(cfg) == JT.count_params(jcfg)
    assert PT.count_active_params(cfg) == JT.count_active_params(jcfg)
    assert (_message(api.serve, _opts(api, arch=arch), device="cpu")
            == _message(japi.serve, _opts(japi, arch=arch)))
