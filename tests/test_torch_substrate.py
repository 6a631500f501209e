"""The port's training substrate against the JAX package's, on the CPU:
the cases of tests/test_substrate.py (with fixed draws where that file
draws with hypothesis), each held to the JAX package's own output where
one exists.

* schedules at every step of a run (rtol 1e-6: both compute in fp32, the
  transcendentals of two libraries may differ in the last bit);
* one ``adamw_update`` from one shared state (``opt_state_from_numpy``) on
  qwen2 SMOKE and on recurrentgemma SMOKE (5 layers over a pattern unit of
  3: one stacked unit and 2 remainder layers, both sides of the decay rule),
  every leaf of the parameters and moments, the step and the norm; the
  decay set equal to the JAX package's, taken on its stacked layout;
* int8 compression, its round trip and error feedback bitwise equal to the
  JAX package's;
* ``SyntheticLM`` and ``TextFileLM`` tokens bitwise equal, with state and
  restore;
* checkpoint round trip (bfloat16 leaves included), keep-k, atomic publish,
  and a checkpoint the JAX package wrote restored by the port;
* ``StepTimer`` and ``PreemptionHandler``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs import qwen2_1_5b as jqwen
from repro.configs import recurrentgemma_2b as jrg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import TextFileLM as JTextFileLM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_latest, save_checkpoint)
from repro_torch.configs import qwen2_1_5b as pqwen
from repro_torch.configs import recurrentgemma_2b as prg
from repro_torch.data import (DataConfig, SyntheticLM, TextFileLM,
                              make_pipeline)
from repro_torch.models import transformer as PT
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import adamw, compression, schedules
from repro_torch.runtime import PreemptionHandler, StepTimer
from repro_torch.tree import tree_paths

torch.set_num_threads(2)


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("name, make", [
    ("constant", lambda m: m.constant(3e-3)),
    ("cosine", lambda m: m.cosine_schedule(3e-3, 5, 100)),
    ("cosine-no-warmup", lambda m: m.cosine_schedule(1e-2, 0, 40, 0.2)),
    ("wsd", lambda m: m.wsd_schedule(3e-3, 5, 70, 25)),
])
def test_schedules_equal_the_reference_at_every_step(name, make):
    want_f, got_f = make(jsched), make(schedules)
    steps = np.arange(0, 121)
    want = np.asarray([float(want_f(s)) for s in steps])
    got = np.asarray([float(got_f(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # a step held as a device scalar (the optimizer's) gives the same
    assert float(got_f(torch.tensor(7, dtype=torch.int32))) == got[7]


def test_wsd_schedule_phases():
    f = schedules.wsd_schedule(1.0, warmup_steps=10, stable_steps=100,
                               decay_steps=50)
    assert float(f(0)) == 0.0
    assert float(f(5)) == pytest.approx(0.5)
    assert float(f(50)) == pytest.approx(1.0)
    assert float(f(109)) == pytest.approx(1.0)
    assert float(f(160)) == pytest.approx(0.01, rel=1e-3)
    assert float(f(120)) > float(f(140)) > float(f(159))


# ------------------------------------------------------------- optimizer
def _random_tree(tree, rng, scale=1.0, positive=False):
    def draw(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return jax.tree.map(draw, tree)


@pytest.mark.parametrize("jmod, pmod", [(jqwen, pqwen), (jrg, prg)],
                         ids=["qwen2", "recurrentgemma"])
def test_adamw_update_equals_the_reference_leaf_for_leaf(jmod, pmod):
    jcfg, pcfg = jmod.SMOKE, pmod.SMOKE
    rng = np.random.default_rng(0)
    shapes = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    params = _random_tree(shapes, rng, 0.1)        # norms and biases too
    grads = _random_tree(shapes, rng, 0.05)
    state = jadamw.AdamWState(step=np.asarray(3, np.int32),
                              mu=_random_tree(shapes, rng, 0.01),
                              nu=_random_tree(shapes, rng, 1e-4, True))
    cfg = adamw.AdamWConfig()
    assert cfg == adamw.AdamWConfig(b1=0.9, b2=0.95, eps=1e-8,
                                    weight_decay=0.1, clip_norm=1.0)
    jnp_tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want_p, want_s, want_norm = jax.jit(jadamw.adamw_update,
                                        static_argnums=4)(
        jnp_tree(grads), jadamw.AdamWState(*map(jnp_tree, state)),
        jnp_tree(params), jnp.float32(1e-2), jadamw.AdamWConfig())

    got_p, got_s, got_norm = adamw.adamw_update(
        params_from_numpy(pcfg, grads, device="cpu"),
        opt_state_from_numpy(pcfg, state, device="cpu"),
        params_from_numpy(pcfg, params, device="cpu"),
        torch.tensor(1e-2), cfg, PT.decay_mask(pcfg))

    assert int(got_s.step) == int(want_s.step) == 4
    assert got_s.step.dtype == torch.int32
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        want = params_from_numpy(pcfg, jax.tree.map(np.asarray, want),
                                 device="cpu")
        for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=0,
                atol=1e-6 * float(w.abs().max()), err_msg="/".join(path))


@pytest.mark.parametrize("jmod, pmod", [(jqwen, pqwen), (jrg, prg)],
                         ids=["qwen2", "recurrentgemma"])
def test_decay_set_is_the_reference_stacked_layout_rule(jmod, pmod):
    """The JAX package decays a leaf of ndim >= 2 in its stacked tree:
    every leaf of a layer inside a whole pattern unit, and only the
    matrices of a remainder layer."""
    shapes = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                     jmod.SMOKE))
    flags = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2),
                                           np.float32), shapes)
    want = params_from_numpy(pmod.SMOKE, flags, device="cpu")
    got = PT.decay_mask(pmod.SMOKE)
    gpaths, wpaths = tree_paths(got), tree_paths(want)
    assert [p for p, _ in gpaths] == [p for p, _ in wpaths]
    for (path, g), (_, w) in zip(gpaths, wpaths):
        assert g == bool(w.flatten()[0]), "/".join(path)
    stacked = pmod.SMOKE.n_super * len(pmod.SMOKE.pattern_unit())
    assert got["layers"][0]["ln1"] and not got["final_norm"]
    if stacked < pmod.SMOKE.n_layers:            # recurrentgemma: 3 + 2
        assert not got["layers"][stacked]["ln1"]
        assert got["layers"][stacked]["mlp"]["w_up"]


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([5.0, -3.0])}
    init, update = adamw.make_optimizer(
        schedules.constant(0.1), adamw.AdamWConfig(weight_decay=0.0,
                                                   clip_norm=None))
    state = init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = update(grads, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 10.0, 20.0, 100.0])
def test_clip_by_global_norm(max_norm):
    g = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
    clipped, norm = adamw.clip_by_global_norm(g, max_norm)
    want_c, want_n = jadamw.clip_by_global_norm(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), g), max_norm)
    assert float(norm) == pytest.approx(float(want_n), rel=1e-7)
    assert float(adamw.global_norm(clipped)) <= max_norm * (1 + 1e-5)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(want_c[k]), rtol=1e-6)
    if float(norm) <= max_norm:
        np.testing.assert_allclose(clipped["a"].numpy(), 10.0)


# ----------------------------------------------------------- compression
@pytest.mark.parametrize("n, scale", [(1, 0.01), (255, 3.0), (256, 1.0),
                                      (1000, 100.0), (2000, 0.5)])
def test_int8_equals_the_reference_bits(n, scale):
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    jq, js = jcomp.compress_int8(jnp.asarray(g))
    q, s = compression.compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = compression.decompress_int8(q, s, (n,), torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcomp.decompress_int8(jq, js, (n,),
                                                      jnp.float32)))
    # block-wise max error is the block's scale / 127
    assert np.abs(deq.numpy() - g).max() <= np.abs(g).max() / 127.0 + 1e-6


def test_int8_rounds_half_to_even():
    # block max 127 -> scale 1: the halves round to the even neighbour
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, s = compression.compress_int8(g)
    assert float(s[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_error_feedback_equals_the_reference_and_preserves_sum():
    rng = np.random.default_rng(0)
    shapes = {"w": (64,), "m": (5, 7)}
    jerr = jcomp.init_error({k: jnp.zeros(s) for k, s in shapes.items()})
    err = compression.init_error({k: torch.zeros(s)
                                  for k, s in shapes.items()})
    total_in, total_out = np.zeros(64), np.zeros(64)
    for _ in range(10):
        g = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
             for k, s in shapes.items()}
        jdeq, jerr = jcomp.compressed_allreduce_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        deq, err = compression.compressed_allreduce_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, err)
        for k in shapes:
            np.testing.assert_array_equal(deq[k].numpy(),
                                          np.asarray(jdeq[k]))
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]))
        total_in += g["w"]
        total_out += deq["w"].numpy()
    np.testing.assert_allclose(total_out + err["w"].numpy(), total_in,
                               rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ data
def _tokens(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def test_synthetic_tokens_equal_the_reference_with_resume():
    fields = dict(global_batch=4, seq_len=16, vocab=128, seed=7)
    jp = JSyntheticLM(JDataConfig(**fields))
    p1 = SyntheticLM(DataConfig(**fields), device="cpu")
    for _ in range(5):
        want, got = _tokens(next(jp)), next(p1)
        assert got["tokens"].dtype == torch.int32
        assert got["tokens"].device.type == "cpu"
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    state = p1.state()
    more = [next(p1) for _ in range(3)]
    p2 = SyntheticLM(DataConfig(**fields), device="cpu")
    p2.restore(state)
    for a, b in zip(more, [next(p2) for _ in range(3)]):
        assert torch.equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      _tokens(next(jp))["tokens"])


def test_pipeline_host_sharding_disjoint():
    fields = dict(global_batch=8, seq_len=8, vocab=64, seed=3, host_count=2)
    h0 = SyntheticLM(DataConfig(**fields, host_index=0), device="cpu")
    h1 = SyntheticLM(DataConfig(**fields, host_index=1), device="cpu")
    b0, b1 = next(h0), next(h1)
    assert b0["tokens"].shape == (4, 8)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    j1 = JSyntheticLM(JDataConfig(**fields, host_index=1))
    np.testing.assert_array_equal(b1["tokens"].numpy(),
                                  _tokens(next(j1))["tokens"])


def test_pipeline_labels_are_next_tokens():
    b = next(SyntheticLM(DataConfig(global_batch=2, seq_len=32, vocab=64,
                                    seed=1), device="cpu"))
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_textfile_tokens_equal_the_reference_with_resume(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 40 + b"tail")
    cfg = dict(global_batch=3, seq_len=50, vocab=256)
    jp = JTextFileLM(JDataConfig(**cfg), str(path))
    p = make_pipeline(DataConfig(**cfg), str(path), device="cpu")
    assert isinstance(p, TextFileLM)
    for _ in range(4):
        want, got = _tokens(next(jp)), next(p)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    q = TextFileLM(DataConfig(**cfg), str(path), device="cpu")
    q.restore(p.state())
    assert torch.equal(next(q)["tokens"], next(p)["tokens"])


def test_pipelines_refuse_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 7"):
        SyntheticLM(DataConfig(frontend="audio"), device="cpu")
    small = tmp_path / "small.txt"
    small.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too few"):
        TextFileLM(DataConfig(seq_len=16), str(small), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(DataConfig())


# ------------------------------------------------------------ checkpoint
def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4),
                       "h": torch.linspace(-2, 2, 5).bfloat16()},
            "opt": adamw.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                    mu=[torch.ones(2)], nu=[torch.zeros(2)])}


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _tree()
    save_checkpoint(d, 10, state, extra={"data": {"step": 5}})
    out = restore_latest(d, _zeros_like(state), device="cpu")
    assert out is not None
    step, restored, extra = out
    assert step == 10 and extra == {"data": {"step": 5}}
    assert isinstance(restored["opt"], adamw.AdamWState)
    for (path, a), (_, b) in zip(tree_paths(state), tree_paths(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    import json
    with open(os.path.join(d, "step_00000010", "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    assert leaves["params/h"]["dtype"] == "bfloat16"
    assert leaves["params/h"]["shape"] == [5]
    assert leaves["opt/.step"] == {"name": "opt/.step",
                                   "file": "opt__.step.npy",
                                   "dtype": "int32", "shape": []}


def test_checkpoint_keep_k_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _tree(), keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert latest_step(d) == 5
    assert latest_step(str(tmp_path / "none")) is None
    m = CheckpointManager(d, interval=3, keep=2)
    assert m.maybe_save(4, _tree()) is None and m.maybe_save(0, _tree()) is None
    assert m.maybe_save(6, _tree()).endswith("step_00000006")
    assert m.maybe_save(7, _tree(), force=True) is not None
    assert m.restore(_zeros_like(_tree()))[0] == 7


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _tree())
    # a crashed write leaves only a .tmp dir -> restore must ignore it
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert restore_latest(d, _zeros_like(_tree()))[0] == 1


def test_checkpoint_written_by_the_reference_restores(tmp_path):
    d = str(tmp_path / "ckpt")
    rng = np.random.default_rng(0)
    flat = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "steps": np.arange(5, dtype=np.int32),
            "nested": {"b": rng.standard_normal(6).astype(np.float32)}}
    tree = jax.tree.map(jnp.asarray, flat)
    tree["h"] = jnp.asarray(flat["w"], jnp.bfloat16)
    j_save(d, 4, tree, extra={"data": {"step": 9}})
    template = {"w": torch.zeros(3, 4),
                "steps": torch.zeros(5, dtype=torch.int32),
                "nested": {"b": torch.zeros(6)},
                "h": torch.zeros(3, 4, dtype=torch.bfloat16)}
    step, got, extra = restore_latest(d, template, device="cpu")
    assert step == 4 and extra == {"data": {"step": 9}}
    assert torch.equal(got["w"], torch.from_numpy(flat["w"]))
    assert torch.equal(got["steps"], torch.from_numpy(flat["steps"]))
    assert torch.equal(got["nested"]["b"],
                       torch.from_numpy(flat["nested"]["b"]))
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"], torch.from_numpy(flat["w"]).bfloat16())


def test_checkpoint_restore_names_a_missing_leaf(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="no leaf 'b'"):
        restore_latest(d, {"a": torch.ones(2), "b": torch.ones(2)})


# -------------------------------------------------------- fault tolerance
def test_straggler_detection():
    t = StepTimer(min_steps=6, ratio=1.5, k_sigma=100.0)
    import time as _t
    for i in range(6):
        t.start()
        _t.sleep(0.01)
        assert t.stop(i) is None       # warmup: below min_steps, never flags
    t.start()
    _t.sleep(0.08)
    rep = t.stop(6)
    assert rep is not None and rep.duration_s > rep.threshold_s
    assert str(rep).startswith("[straggler] step 6:")
    with pytest.raises(RuntimeError, match="before start"):
        t.stop(7)


def test_step_timer_synchronizes_on_a_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    t = StepTimer(device="cuda")
    t.start()
    t.stop(0)
    assert len(synced) == 2
    StepTimer(device="cpu").start()
    assert len(synced) == 2


def test_preemption_handler_flag():
    h = PreemptionHandler(install=False)
    assert not h.should_stop
    h.request_stop()
    assert h.should_stop


def test_preemption_handler_catches_sigterm():
    import signal
    h = PreemptionHandler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not h._handler
