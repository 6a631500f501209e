"""The port's ``build_step`` against the JAX package's, on the CPU.

* For every runnable cell, on mocked pod (16x16) and multipod (2x16x16)
  meshes and on each package's real 1x1 host mesh, the in and out specs of
  the built step, its ``act_sharding`` and ``donate`` equal the
  reference's.  On a mocked mesh the expected values come from the
  reference's own ``sharding`` and ``policy`` calls, as its ``build_step``
  makes them (that function needs a real mesh), with one difference: the
  activation constraint is resolved on the batch the forward sees, the
  microbatch in training and the whole batch in prefill and decode, where
  the reference resolves the microbatch in every mode (for an arch with
  ``grad_accum`` > 1 that left a prefill's batch unsplit over 'data' and
  every data rank repeating the whole batch's work); on the host mesh
  from its ``build_step`` itself.  A port leaf of layer i is held to the stacked
  reference leaf as in ``tests/test_torch_sharding.py``.  Equality, no
  tolerance.
* At SMOKE size, in float32, on the host mesh, each built step, run through
  ``sharded``, equals the reference's ``jax.jit`` of its ``build_step`` on
  the same converted weights and inputs within 2e-4: the train step on the
  loss, the updated parameters and the metrics, prefill on the logits and
  the cache, decode on the logits and the cache.
* ``_constrain_act`` returns a plain tensor as it is.
"""
import concurrent.futures
import dataclasses
import functools
import inspect
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jregistry
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import sharding as jshard
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as pregistry
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps as psteps
from repro_torch.models import transformer as PT
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, state_from_numpy)
from test_torch_sharding import (MULTIPOD, POD, FakeMesh, _cache_stacks,
                                 _held, _leaves, _param_stacks, _ref_paths,
                                 _spec, _spec_compare, _xattn_placeholders)

torch.set_num_threads(2)

CELLS = pregistry.runnable_cells()
MESHES = ["pod", "multipod", "host"]
TOL = 2e-4
CONV_RTOL = 2.0 ** -7            # one bfloat16 step: the stored conv states


@functools.lru_cache(maxsize=None)
def _meshes(which):
    """(reference mesh, port mesh) of one kind."""
    if which == "host":
        return jmesh.make_host_mesh(), pmesh.make_host_mesh("cpu")
    shape = POD if which == "pod" else MULTIPOD
    return FakeMesh(**shape), FakeMesh(**shape)


@functools.lru_cache(maxsize=None)
def _ref_cache_shapes(arch, shape_name):
    """The reference prefill step's emitted cache, abstract (its
    structure does not depend on the activation constraint)."""
    jarch = jregistry.get(arch)
    spec = jregistry.input_specs(jarch, shape_name)
    extras = [k for k in ("enc_inputs", "img_embeds") if k in spec]
    params = jsteps.abstract_params(jarch.config)

    def prefill(p, tokens, *extra):
        return JT.forward(p, jarch.config, tokens, emit_cache=True,
                          **dict(zip(extras, extra)))[1]

    return jax.eval_shape(prefill, params, spec["tokens"],
                          *(spec[k] for k in extras))


def _expected(arch, shape_name, jmesh_):
    """The reference's (in specs, out specs, donate, act_sharding) of one
    cell on a mocked mesh, by its ``build_step``'s own calls."""
    jarch = jregistry.get(arch)
    cfg = jarch.config
    shape = jregistry.SHAPES[shape_name]
    policy = jshard.make_policy(cfg, jmesh_)
    # the batch the forward sees: the microbatch in training, the whole
    # batch in prefill and decode (the reference's build_step resolves the
    # microbatch in every mode)
    fwd_b = shape.global_batch
    if shape.mode == "train":
        fwd_b = max(shape.global_batch // max(1, cfg.grad_accum), 1)
    tok = policy.resolve((fwd_b, shape.seq_len), ["batch", "seq"])
    act = (tok[0] if len(tok) > 0 else None, tok[1] if len(tok) > 1 else None)
    p_sh = jshard.param_shardings(cfg, policy, jsteps.abstract_params(cfg))
    spec = jregistry.input_specs(jarch, shape_name)
    logits = policy.named((shape.global_batch, 1, cfg.vocab),
                          ["batch", None, "vocab"])
    if shape.mode == "train":
        o_sh = jadamw.AdamWState(step=(), mu=p_sh, nu=p_sh)
        b_sh = jshard.batch_shardings(cfg, policy, spec["batch"])
        metrics = {k: () for k in ("loss", "lr", "grad_norm")}
        return (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics), (0, 1), act
    if shape.mode == "prefill":
        extras = [k for k in ("enc_inputs", "img_embeds") if k in spec]
        tok_sh = policy.named(tuple(spec["tokens"].shape), ["batch", "seq"])
        extra_sh = tuple(policy.named(tuple(spec[k].shape),
                                      ["batch", "seq", None])
                         for k in extras)
        cache_sh = jshard.cache_shardings(
            cfg, policy, _ref_cache_shapes(arch, shape_name))
        return ((p_sh, tok_sh) + extra_sh, (logits, cache_sh), (), act)
    cache_sh = jshard.cache_shardings(cfg, policy, spec["cache"])
    tok_sh = policy.named((shape.global_batch, 1), ["batch", None])
    return (p_sh, cache_sh, tok_sh), (logits, cache_sh), (1,), act


def _built_cfg(fn):
    """The config a built step closes over (its ``act_sharding`` set)."""
    fn = inspect.unwrap(fn)
    cfgs = [c.cell_contents for c in fn.__closure__ or ()
            if isinstance(c.cell_contents, (JT.ModelConfig, PT.ModelConfig))]
    assert len(cfgs) == 1, fn
    return cfgs[0]


def _ref_build(arch, shape_name, jmesh_):
    """The reference's own ``build_step`` on its host mesh."""
    fn, in_sh, out_sh, donate, _ = jsteps.build_step(
        jregistry.get(arch), shape_name, jmesh_)
    return in_sh, out_sh, donate, _built_cfg(fn).act_sharding


def _compare_tree(port, ref, stacks, xattn=frozenset()):
    """Spec of every port leaf against its reference leaf; every reference
    leaf reached (gated cross-attention cache placeholders aside)."""
    reached = _held(port, ref, stacks, _spec_compare)
    want = {p for p in _ref_paths(ref) if p[:3] not in xattn}
    assert reached == want


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_build_step_specs_equal_the_reference(arch, shape_name, which):
    jmesh_, pmesh_ = _meshes(which)
    parch = pregistry.get(arch)
    fn, in_sh, out_sh, donate, _ = psteps.build_step(parch, shape_name,
                                                     pmesh_)
    if which == "host":
        want_in, want_out, want_donate, want_act = _ref_build(
            arch, shape_name, jmesh_)
    else:
        want_in, want_out, want_donate, want_act = _expected(
            arch, shape_name, jmesh_)
    assert donate == tuple(want_donate)
    assert len(in_sh) == len(want_in) and len(out_sh) == len(want_out)
    cfg = parch.config
    mode = pregistry.SHAPES[shape_name].mode
    pstacks, cstacks = _param_stacks(cfg), _cache_stacks(cfg)
    assert _built_cfg(fn).act_sharding == tuple(want_act)
    _compare_tree(in_sh[0], want_in[0], pstacks)
    if mode == "train":
        _compare_tree(out_sh[0], want_out[0], pstacks)
        for got_o, want_o in ((in_sh[1], want_in[1]),
                              (out_sh[1], want_out[1])):
            assert _spec(got_o.step) == _spec(want_o.step) == ()
            _compare_tree(got_o.mu, want_o.mu, pstacks)
            _compare_tree(got_o.nu, want_o.nu, pstacks)
        assert {k: _spec(v) for k, v in in_sh[2].items()} == {
            k: _spec(v) for k, v in want_in[2].items()}
        assert {k: _spec(v) for k, v in out_sh[2].items()} == {
            k: _spec(v) for k, v in want_out[2].items()}
        return
    xattn = frozenset(_xattn_placeholders(cfg))
    assert _spec(out_sh[0]) == _spec(want_out[0])
    if mode == "prefill":
        for got, want in zip(in_sh[1:], want_in[1:]):
            assert _spec(got) == _spec(want)
        got_cache, want_cache = dict(out_sh[1]), dict(want_out[1])
        # the reference's cross entry is None without cross features
        want_cache = {k: v for k, v in want_cache.items() if v is not None}
        assert set(got_cache) == set(want_cache)
        for key in got_cache:
            if key == "layers":
                _compare_tree({"layers": got_cache[key]},
                              {"layers": want_cache[key]}, cstacks, xattn)
            else:
                assert _spec(got_cache[key]) == _spec(want_cache[key]), key
        return
    _compare_tree(in_sh[1], want_in[1], cstacks, xattn)
    _compare_tree(out_sh[1], want_out[1], cstacks, xattn)
    assert _spec(in_sh[2]) == _spec(want_in[2])


# ---------------------------------------------------------------------
# the built steps run, against the reference's jitted steps
# ---------------------------------------------------------------------
NUMERIC = ["qwen2_1_5b", "mixtral_8x7b", "falcon_mamba_7b",
           "recurrentgemma_2b", "seamless_m4t_medium", "llama32_vision_90b"]
B, S = 2, 16


def _smoke(arch):
    """Each package's ArchSpec with its SMOKE config in float32."""
    jarch, parch = jregistry.get(arch), pregistry.get(arch)
    jcfg = dataclasses.replace(jarch.smoke, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(parch.smoke, param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    return (dataclasses.replace(jarch, config=jcfg),
            dataclasses.replace(parch, config=pcfg))


def _inputs(cfg, rng, seq):
    """Tokens and the front end's features, as numpy arrays."""
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, seq),
                                  dtype=np.int32)}
    if cfg.encoder_decoder:
        out["enc_inputs"] = rng.standard_normal((B, seq, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "vision":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.img_seq, cfg.d_model)).astype(np.float32)
    return out


def _close(got, want, path=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=0, atol=TOL, err_msg=path)


def _caches_close(got, want):
    """Cache leaves: integers exact, float32 within TOL, the bfloat16 conv
    states also within one bfloat16 step (tests/test_torch_families.py's
    rule)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        if not g.is_floating_point():
            assert torch.equal(g.reshape(w.shape), w), path
        else:
            np.testing.assert_allclose(
                g.float().numpy(), w.float().numpy(),
                rtol=CONV_RTOL if g.dtype == torch.bfloat16 else 0,
                atol=TOL, err_msg=str(path))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_port(parch, shape_name, *args):
    mesh = pmesh.make_host_mesh("cpu")
    fn, in_sh, out_sh, _, _ = psteps.build_step(parch, shape_name, mesh)
    out = psteps.sharded(fn, in_sh, out_sh)(*args)
    assert not dist.is_initialized()
    return out


def _run_ref(jarch, shape_name, *args):
    mesh = jmesh.make_host_mesh()
    fn, in_sh, out_sh, donate, _ = jsteps.build_step(jarch, shape_name, mesh)
    with mesh:
        return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(*args)


def _reference_steps(arch):
    """The reference's SMOKE weights of ``arch`` (key 0) and its jitted
    train, prefill and decode steps, inputs and outputs, as numpy arrays
    (inputs are copied before a step that donates them)."""
    jarch, parch = _smoke(arch)
    cfg = parch.config
    init = jax.jit(functools.partial(JT.init_params, cfg=jarch.config))
    tree = _np(init(jax.random.PRNGKey(0)))
    out = {"tree": tree}

    rng = np.random.default_rng(3)
    data = _inputs(cfg, rng, S)
    data["labels"] = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    # past the warm-up's first step, where the learning rate is 0
    jopt = jadamw.adamw_init(jax.tree.map(jnp.asarray, tree))
    jopt = jopt._replace(step=jnp.asarray(100, jnp.int32))
    opt_np = _np(jopt)
    res = _run_ref(jarch, "train_4k", jax.tree.map(jnp.asarray, tree), jopt,
                   {k: jnp.asarray(v) for k, v in data.items()})
    out["train"] = (data, opt_np, _np(res))

    data = _inputs(cfg, np.random.default_rng(4), S)
    extras = [k for k in ("enc_inputs", "img_embeds") if k in data]
    logits, cache = _run_ref(
        jarch, "prefill_32k", jax.tree.map(jnp.asarray, tree),
        jnp.asarray(data["tokens"]), *(jnp.asarray(data[k]) for k in extras))
    out["prefill"] = (data, _np(logits), _np(dict(cache)))

    # a cache with random contents at position 5 (the rows past it are
    # masked), the same in both packages
    rng = np.random.default_rng(5)

    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" or str(a.dtype) == "bfloat16":
            return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                               ).astype(a.dtype)
        return jnp.asarray(a)

    jcache = jax.tree.map(fill, JT.init_cache(jarch.config, B, max_seq=S))
    jcache = dict(jcache, pos=jnp.asarray(5, jnp.int32))
    cache_np = _np(jcache)
    tokens = rng.integers(0, cfg.vocab, size=(B, 1), dtype=np.int32)
    logits, cache = _run_ref(jarch, "decode_32k", jax.tree.map(
        jnp.asarray, tree), jcache, jnp.asarray(tokens))
    out["decode"] = (cache_np, tokens, _np(logits), _np(dict(cache)))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_jobs():
    """:func:`_reference_steps` of each numeric config, started at the
    module's first test, one process each (JAX's tracing and compiling of
    the reference steps is most of this module's time); the spec tests run
    meanwhile."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(NUMERIC),
                                                mp_context=ctx) as pool:
        yield {arch: pool.submit(_reference_steps, arch) for arch in NUMERIC}


@pytest.mark.parametrize("arch", NUMERIC)
def test_built_train_step_equals_the_reference(reference_jobs, arch):
    _, parch = _smoke(arch)
    ref = reference_jobs[arch].result()
    tree = ref["tree"]
    data, jopt, (new_j, opt_j, m_j) = ref["train"]
    pparams = params_from_numpy(parch.config, tree, device="cpu")
    popt = opt_state_from_numpy(parch.config, jopt, device="cpu")
    new_p, opt_p, m_p = _run_port(parch, "train_4k", pparams, popt,
                                  {k: torch.from_numpy(v)
                                   for k, v in data.items()})
    assert set(m_p) == set(m_j) == {"loss", "lr", "grad_norm"}
    for k in m_p:
        _close(m_p[k], m_j[k], k)
    assert int(opt_p.step) == int(opt_j.step) == 101
    want = params_from_numpy(parch.config, new_j, device="cpu")
    moved = 0
    for (path, g), (_, w), (_, p0) in zip(
            _leaves(new_p), _leaves(want),
            _leaves(params_from_numpy(parch.config, tree, device="cpu"))):
        _close(g, w.numpy(), str(path))
        moved += not torch.equal(g, p0)
    assert moved > 0


@pytest.mark.parametrize("arch", NUMERIC)
def test_built_prefill_step_equals_the_reference(reference_jobs, arch):
    _, parch = _smoke(arch)
    ref = reference_jobs[arch].result()
    data, logits_j, cache_j = ref["prefill"]
    pparams = params_from_numpy(parch.config, ref["tree"], device="cpu")
    extras = [k for k in ("enc_inputs", "img_embeds") if k in data]
    logits_p, cache_p = _run_port(
        parch, "prefill_32k", pparams, torch.from_numpy(data["tokens"]),
        *(torch.from_numpy(data[k]) for k in extras))
    assert tuple(logits_p.shape) == (B, 1, parch.config.vocab)
    _close(logits_p, logits_j, "logits")
    _caches_close(cache_p, state_from_numpy(parch.config, cache_j,
                                            device="cpu"))


@pytest.mark.parametrize("arch", NUMERIC)
def test_built_decode_step_equals_the_reference(reference_jobs, arch):
    _, parch = _smoke(arch)
    cfg = parch.config
    ref = reference_jobs[arch].result()
    jcache, tokens, logits_j, cache_j = ref["decode"]
    pparams = params_from_numpy(cfg, ref["tree"], device="cpu")
    pcache = state_from_numpy(cfg, jcache, device="cpu")
    logits_p, cache_p = _run_port(parch, "decode_32k", pparams, pcache,
                                  torch.from_numpy(tokens))
    _close(logits_p, logits_j, "logits")
    _caches_close(cache_p, state_from_numpy(cfg, cache_j, device="cpu"))


def test_constrain_act_returns_a_plain_tensor_as_it_is():
    x = torch.randn(2, 3, 4)
    for act in (None, ("data", "model"), (("pod", "data"), None)):
        cfg = PT.ModelConfig(act_sharding=act)
        assert PT._constrain_act(x, cfg) is x
