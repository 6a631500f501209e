"""The port's sharding policy, meshes and the registry's abstract input specs
against the JAX package's, on the CPU.

* Every parameter leaf of the ten LM archs at their published configs gets
  the JAX package's spec for the matching stacked leaf (the leading layers
  entry dropped: the port keeps one dict per layer, layer i being
  ``blocks[i % U][i // U]``), on mocked pod (16x16) and multipod (2x16x16)
  meshes and on each package's real 1x1 host mesh.  The same holds for
  ``batch_shardings`` on the train and prefill cells and
  ``cache_shardings`` on the decode cells of ``runnable_cells()``, the
  reference's cache unstacked by the same rule.  Equality, no tolerance.
* ``runnable_cells()`` and ``input_specs`` (shapes and dtypes, leaf for
  leaf) are the JAX package's.
* Under a fake process group of 256 and 512 ranks, ``place`` gives each
  meta leaf a local shape of its global dim over the product of its axes'
  sizes; the production mesh refuses too few ranks; the host mesh, a
  ``serve()`` run and the train CLI leave no process group behind.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import registry as jregistry
from repro.launch import mesh as jmesh
from repro.models import sharding as jshard
from repro.models import transformer as JT
from repro_torch.configs import registry as pregistry
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train as ptrain
from repro_torch.models import sharding as pshard
from repro_torch.models import transformer as PT
from repro_torch.serving import api as papi

torch.set_num_threads(2)

LM_ARCHS = [n for n in pregistry.ARCH_NAMES if n != "alexnet"]
CELLS = pregistry.runnable_cells()


class FakeMesh:
    """A mesh's axis sizes alone (the resolver's pure logic, no devices)."""

    def __init__(self, **shape):
        self.shape = shape


POD = dict(data=16, model=16)
MULTIPOD = dict(pod=2, data=16, model=16)
MESHES = ["pod", "multipod", "host"]


@functools.lru_cache(maxsize=None)
def _meshes(which):
    """(reference mesh, port mesh) of one kind."""
    if which == "host":
        return jmesh.make_host_mesh(), pmesh.make_host_mesh("cpu")
    shape = POD if which == "pod" else MULTIPOD
    return FakeMesh(**shape), FakeMesh(**shape)


def _spec(s):
    """A resolved sharding as a plain tuple (mocked meshes give the spec
    itself, real ones a sharding object holding it)."""
    return tuple(getattr(s, "spec", s))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, path=()):
    """(path, leaf) of a port tree (dicts and lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _ref_paths(tree):
    """Every leaf path of a JAX package tree, keys and indices."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(tuple(getattr(p, "key", getattr(p, "idx", None))
                         for p in path))
    return out


def _unstack(cfg, stack, i):
    """Where layer i of the port sits in one of the JAX package's layer
    stacks, ``stack`` = (its path, its blocks key, its rem key), and
    whether that leaf is stacked (convert's rule)."""
    path, blocks, rem = stack
    u = len(cfg.pattern_unit())
    s, j = divmod(i, u)
    if s < cfg.n_super:
        return path + (blocks, j), True
    return path + (rem, i - cfg.n_super * u), False


def _held(port_tree, ref_tree, stacks, compare):
    """Call ``compare(port_leaf, ref_leaf, stacked, path)`` on every port
    leaf and its reference leaf (``stacks``: port key -> (config, stack));
    return the reference paths reached."""
    reached = set()
    for path, leaf in _leaves(port_tree):
        if path[0] in stacks:
            cfg, stack = stacks[path[0]]
            where, stacked = _unstack(cfg, stack, path[1])
            ref_path = where + path[2:]
        else:
            ref_path, stacked = path, False
        compare(leaf, _get(ref_tree, ref_path), stacked, path)
        reached.add(ref_path)
    return reached


def _param_stacks(cfg):
    stacks = {"layers": (cfg, (("decoder",), "blocks", "rem"))}
    if cfg.encoder_decoder:
        stacks["encoder"] = (PT.encoder_config(cfg),
                             (("encoder",), "blocks", "rem"))
    return stacks


def _cache_stacks(cfg):
    """The reference's decode cache keeps its stacks as a (blocks, rem)
    pair under "layers"."""
    return {"layers": (cfg, (("layers",), 0, 1))}


def _spec_compare(port, ref, stacked, path):
    want = _spec(ref)
    if stacked:
        want = want[1:]                     # the stacked-layers entry
    assert _spec(port) == want, (path, _spec(port), want)


# ---------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = jregistry.get(arch).config
    return jax.eval_shape(functools.partial(JT.init_params, cfg=cfg),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_the_reference(arch, which):
    jmesh_, pmesh_ = _meshes(which)
    jcfg, pcfg = jregistry.get(arch).config, pregistry.get(arch).config
    jshapes = _ref_param_shapes(arch)
    jpolicy, ppolicy = (jshard.make_policy(jcfg, jmesh_),
                        pshard.make_policy(pcfg, pmesh_))
    assert (ppolicy.tp_mode, ppolicy.zero3, ppolicy.pure_dp) == (
        jpolicy.tp_mode, jpolicy.zero3, jpolicy.pure_dp)
    params = pshard.meta_params(pcfg)
    psh = pshard.param_shardings(pcfg, ppolicy, params)
    jsh = jshard.param_shardings(jcfg, jpolicy, jshapes)
    stacks = _param_stacks(pcfg)
    reached = _held(psh, jsh, stacks, _spec_compare)

    # ... every reference leaf is some port leaf's, and the shapes agree
    def shape_compare(port, ref, stacked, path):
        want = tuple(ref.shape)[1:] if stacked else tuple(ref.shape)
        assert (tuple(port.shape), _dtype(port)) == (want, str(ref.dtype)), \
            (path, tuple(port.shape), want)

    _held(params, jshapes, stacks, shape_compare)
    assert reached == set(_ref_paths(jshapes))


# ---------------------------------------------------------------------
# cells: batches, caches, input specs
# ---------------------------------------------------------------------
def _dtype(x):
    return str(x.dtype).removeprefix("torch.")


def _xattn_placeholders(cfg):
    """The reference's scalar cache placeholders of gated cross-attention
    layers (the port's entry for such a layer is ``{}``)."""
    unit = cfg.pattern_unit()
    paths = {("layers", 0, j) for j, t in enumerate(unit) if t == "xattn"}
    n_rem = cfg.n_layers - cfg.n_super * len(unit)
    paths |= {("layers", 1, r) for r in range(n_rem)
              if unit[r % len(unit)] == "xattn"}
    return paths


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    jspec = jregistry.input_specs(jregistry.get(arch), shape)
    pspec = pregistry.input_specs(pregistry.get(arch), shape)
    cfg = pregistry.get(arch).config
    assert set(pspec) == set(jspec)

    def compare(port, ref, stacked, path):
        want = tuple(ref.shape)[1:] if stacked else tuple(ref.shape)
        assert port.device.type == "meta", path
        assert (tuple(port.shape), _dtype(port)) == (want, str(ref.dtype)), \
            (path, tuple(port.shape), _dtype(port), want, str(ref.dtype))

    if "cache" not in pspec:
        assert _held(pspec, jspec, {}, compare) == set(_ref_paths(jspec))
        return
    compare(pspec["tokens"], jspec["tokens"], False, ("tokens",))
    reached = _held(pspec["cache"], jspec["cache"], _cache_stacks(cfg),
                    compare)
    assert reached == {p for p in _ref_paths(jspec["cache"])
                       if p[:3] not in _xattn_placeholders(cfg)}


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape, which):
    jmesh_, pmesh_ = _meshes(which)
    jcfg, pcfg = jregistry.get(arch).config, pregistry.get(arch).config
    jpol, ppol = jshard.make_policy(jcfg, jmesh_), pshard.make_policy(
        pcfg, pmesh_)
    jspec = jregistry.input_specs(jregistry.get(arch), shape)
    pspec = pregistry.input_specs(pregistry.get(arch), shape)
    mode = pregistry.SHAPES[shape].mode
    if mode == "decode":
        jsh = jshard.cache_shardings(jcfg, jpol, jspec["cache"])
        psh = pshard.cache_shardings(pcfg, ppol, pspec["cache"])
        reached = _held(psh, jsh, _cache_stacks(pcfg), _spec_compare)
        assert reached == {
            p for p in _ref_paths(jspec["cache"])
            if p[:3] not in _xattn_placeholders(pcfg)}
        return
    jbatch = jspec["batch"] if mode == "train" else jspec
    pbatch = pspec["batch"] if mode == "train" else pspec
    jsh = jshard.batch_shardings(jcfg, jpol, jbatch)
    psh = pshard.batch_shardings(pcfg, ppol, pbatch)
    assert {k: _spec(v) for k, v in psh.items()} == {
        k: _spec(v) for k, v in jsh.items()}


def test_runnable_cells_equal_the_reference():
    assert CELLS == jregistry.runnable_cells()
    assert len(CELLS) == 33


# ---------------------------------------------------------------------
# the resolver (tests/test_integration.py's cases)
# ---------------------------------------------------------------------
def test_policy_tp_vs_fsdp_mode():
    # single-device mesh: everything resolves to replicated but must not
    # error
    mesh = pmesh.make_host_mesh("cpu")
    for arch_name in ("qwen2_1_5b", "mixtral_8x7b", "falcon_mamba_7b"):
        cfg = pregistry.get(arch_name).config
        policy = pshard.make_policy(cfg, mesh)
        shapes = pshard.meta_params(cfg)
        sh = pshard.param_shardings(cfg, policy, shapes)
        assert len(list(_leaves(sh))) == len(list(_leaves(shapes)))
        assert all(s.placements == (Replicate(), Replicate())
                   and set(s.spec) <= {None} for _, s in _leaves(sh))


def test_resolver_divisibility_fallbacks():
    pol = pshard.ShardingPolicy(mesh=FakeMesh(**POD), tp_mode=True)
    # heads=56 (deepseek): not divisible by 16 -> replicated
    assert pol.resolve((7168, 7168), ["embed", "heads"]) == ("data", "model")
    assert pol.resolve((7168, 56 * 128), ["embed", "heads"])[1] == "model"
    # kv_heads=8: the flattened dim 1024 divides 16 -> sharded
    assert pol.resolve((4096, 8 * 128), ["embed", "kv_heads"])[1] == "model"
    # expert=16 divides -> 'model'; then ff can't reuse 'model'
    spec = pol.resolve((16, 4096, 6400), ["expert", "embed", "ff"])
    assert spec[0] == "model" and spec[2] is None
    # expert=8 does not divide 16 -> ff gets 'model'
    spec = pol.resolve((8, 4096, 14336), ["expert", "embed", "ff"])
    assert spec[0] is None and spec[2] == "model"


@pytest.mark.parametrize("zero3,pure_dp", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("which", ["pod", "multipod"])
def test_resolver_equals_the_reference_on_drawn_cases(which, zero3, pure_dp):
    """Shapes and logical names drawn from a seed (dims that divide 2, 16,
    32, 256, 512 or none of them; every logical name, None and an unknown
    one), resolved by both packages' policies."""
    rng = np.random.default_rng(7)
    names = list(pshard.RULES) + [None, "layers"]
    dims = [1, 2, 8, 16, 24, 32, 48, 256, 512, 1000, 4096, 4100]
    shape = POD if which == "pod" else MULTIPOD
    jpol = jshard.ShardingPolicy(mesh=FakeMesh(**shape), tp_mode=True,
                                 zero3=zero3, pure_dp=pure_dp)
    ppol = pshard.ShardingPolicy(mesh=FakeMesh(**shape), tp_mode=True,
                                 zero3=zero3, pure_dp=pure_dp)
    for _ in range(300):
        rank = int(rng.integers(0, 5))
        case = (tuple(int(d) for d in rng.choice(dims, rank)),
                [names[i] for i in rng.integers(0, len(names), rank)])
        assert ppol.resolve(*case) == tuple(jpol.resolve(*case)), case


def test_cache_shardings_kv_and_ssm():
    cfg = pregistry.get("mixtral_8x7b").config
    pol = pshard.ShardingPolicy(mesh=FakeMesh(**POD), tp_mode=True)
    cache = PT.init_cache(cfg, 128, max_seq=4096, device="meta")
    sh = pshard.cache_shardings(cfg, pol, cache)
    kv = [s for p, s in _leaves(sh) if p[-1] == "k"]
    assert len(kv) == cfg.n_layers
    # mixtral kv=8 heads won't shard over 16 -> time dim takes 'model'
    # (one dim fewer than the reference's stacked cache)
    assert kv[0][2] == "model" and kv[0][0] == "data"
    mamba = pregistry.get("falcon_mamba_7b").config
    sh = pshard.cache_shardings(mamba, pol, PT.init_cache(
        mamba, 128, max_seq=64, device="meta"))
    assert sh["layers"][0]["mamba"] == {"h": ("data", "model", None),
                                        "conv": ("data", None, "model")}


def test_placements_follow_mesh_order():
    """A dim over ("pod", "data") is Shard(i) on both mesh dims."""
    names = ("pod", "data", "model")
    assert pshard.spec_placements(names, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert pshard.spec_placements(names, (None, ("data", "model"))) == (
        Replicate(), Shard(1), Shard(1))
    assert pshard.spec_placements(("data", "model"), ()) == (
        Replicate(), Replicate())


# ---------------------------------------------------------------------
# production meshes under a fake process group
# ---------------------------------------------------------------------
@pytest.fixture
def fake_group(request):
    """A fake default process group of ``request.param`` ranks (rank 0),
    destroyed after the test, pass or fail."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def _local_shape(shape, spec, axes):
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in (entry,) if isinstance(entry, str) else entry or ():
            n *= axes[a]
        assert dim % n == 0
        out.append(dim // n)
    return tuple(out)


def _check_placed(placed, shardings, axes):
    n = 0
    for (path, t), (_, s) in zip(_leaves(placed), _leaves(shardings)):
        assert isinstance(t, DTensor), path
        assert tuple(t.to_local().shape) == _local_shape(
            tuple(t.shape), s.spec, axes), (path, s.spec)
        assert t.to_local().device.type == "meta"
        n += 1
    return n


@pytest.mark.parametrize("fake_group,multi_pod", [(256, False), (512, True)],
                         indirect=["fake_group"], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_place_on_production_meshes_gives_local_shapes(fake_group, multi_pod,
                                                       arch):
    mesh = pmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert mesh.size() == fake_group
    axes = pshard.mesh_axes(mesh)
    assert axes == (MULTIPOD if multi_pod else POD)
    cfg = pregistry.get(arch).config
    policy = pshard.make_policy(cfg, mesh)
    params = pshard.meta_params(cfg)
    sh = pshard.param_shardings(cfg, policy, params)
    placed = pshard.place(params, sh)
    assert _check_placed(placed, sh, axes) == len(list(_leaves(params)))
    # the same specs as on the mocked mesh
    fake = pshard.param_shardings(cfg, pshard.make_policy(cfg, FakeMesh(
        **axes)), params)
    assert [s.spec for _, s in _leaves(sh)] == [s for _, s in _leaves(fake)]
    for shape in pregistry.SHAPES:
        if (arch, shape) not in CELLS:
            continue
        spec = pregistry.input_specs(pregistry.get(arch), shape)
        if "cache" in spec:
            tree, sh = spec["cache"], pshard.cache_shardings(
                cfg, policy, spec["cache"])
        else:
            tree = spec.get("batch", spec)
            sh = pshard.batch_shardings(cfg, policy, tree)
        _check_placed(pshard.place(tree, sh), sh, axes)


@pytest.mark.parametrize("fake_group", [256], indirect=True)
def test_production_mesh_refuses_too_few_ranks(fake_group):
    with pytest.raises(RuntimeError, match="needs 512 ranks.*has 256"):
        pmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_production_mesh_refuses_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks.*torchrun"):
        pmesh.make_production_mesh(device_type="cpu")


# ---------------------------------------------------------------------
# the host mesh, serve() and the train CLI
# ---------------------------------------------------------------------
def test_host_mesh_needs_no_process_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh = pmesh.make_host_mesh("cpu")
    assert pshard.mesh_axes(mesh) == {"data": 1, "model": 1}
    assert pshard.mesh_device(mesh) == torch.device("cpu")
    assert not dist.is_initialized()
    cfg = pregistry.get("qwen2_1_5b").smoke
    got = papi.build_params(cfg, mesh)
    want = PT.init_params(cfg, seed=0, device="cpu")
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert type(g) is torch.Tensor, path
        assert torch.equal(g, w), path
    # a tensor already on the mesh's device is placed as itself
    sh = pshard.param_shardings(cfg, pshard.make_policy(cfg, mesh), want)
    placed = pshard.place(want, sh)
    assert all(p is w for (_, p), (_, w) in zip(_leaves(placed),
                                                _leaves(want)))
    assert not dist.is_initialized()


def test_serve_places_weights_through_the_host_mesh(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    seen = []
    build = papi.build_params

    def spy(cfg, mesh):
        seen.append(pshard.mesh_axes(mesh))
        return build(cfg, mesh)

    monkeypatch.setattr(papi, "build_params", spy)
    opts = papi.ServeOptions()
    opts.workload.requests, opts.workload.prompt_len = 2, 4
    opts.workload.gen_len, opts.workload.rate = 3, 1e9
    opts.engine.slots = 2
    report = papi.serve(opts, device="cpu")
    assert seen == [{"data": 1, "model": 1}]
    assert report.summary["requests_done"] == 2
    assert not dist.is_initialized()


def test_train_places_weights_through_the_host_mesh(monkeypatch, capsys):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    meshes, placed = [], []
    make, place = ptrain.make_host_mesh, pshard.place

    def make_spy(device):
        meshes.append(device)
        return make(device)

    def place_spy(tree, shardings):
        placed.append(len(list(_leaves(tree))))
        return place(tree, shardings)

    monkeypatch.setattr(ptrain, "make_host_mesh", make_spy)
    monkeypatch.setattr(pshard, "place", place_spy)
    ptrain.main(["--device", "cpu", "--scale", "smoke", "--steps", "1",
                 "--batch", "2", "--seq", "16"])
    assert "done: 1 steps" in capsys.readouterr().out
    cfg = pregistry.get("qwen2_1_5b").smoke
    assert meshes == [torch.device("cpu")]
    assert placed == [len(list(_leaves(PT.param_shapes(cfg))))]
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_train_refuses_the_production_meshes(mesh):
    with pytest.raises(NotImplementedError, match="item 9"):
        ptrain.main(["--device", "cpu", "--mesh", mesh])
