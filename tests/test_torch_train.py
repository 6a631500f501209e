"""The port's training loop on the CPU: the cases of
tests/test_integration.py for training, and the port's steps held to the
JAX package's from one state.

* the loss falls by at least 0.8 nats on bigram data (the JAX package's
  tiny config and schedule, 150 steps);
* 6 steps equal 3 + save + restore + 3, bit for bit;
* ``_accum_grads`` over 4 microbatches against the full batch, and against
  the JAX package's ``_accum_grads`` (float32, GRAD_RTOL of each leaf's
  largest magnitude);
* ``remat`` changes no number;
* three ``train_step``s of the port against three of the JAX package's CLI
  step from one state (qwen2 SMOKE, float32): the losses and norms at
  rtol 1e-5, every parameter at GRAD_RTOL of its largest magnitude but the
  key biases, whose gradient is rounding noise (see the test);
* the CLI (``python -m repro_torch.launch.train --device cpu --scale
  smoke``) runs and resumes, with int8 compression and accumulation too;
  ``--mesh pod`` raises naming ROADMAP §1 item 9, and the default
  ``--device cuda`` raises without a card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_1_5b as jqwen
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import _accum_grads as j_accum_grads
from repro.launch.train import _schedule as j_schedule
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import restore_latest, save_checkpoint
from repro_torch.configs import qwen2_1_5b as pqwen
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import (_accum_grads, loss_and_grads,
                                      make_train_step)
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, schedules
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
GRAD_RTOL = 2e-4


def _tiny_cfg(**fields):
    return PT.ModelConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=64, scan_chunk=16, attention_impl="dot", remat=False,
        **fields)


def _close_tree(got, want, rtol=GRAD_RTOL):
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=0, atol=rtol * float(w.abs().max()),
                                   err_msg="/".join(path))


def _equal_tree(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert torch.equal(x, y), "/".join(path)


def test_training_reduces_loss_on_structured_data():
    cfg = _tiny_cfg()
    params = PT.init_params(cfg, 0, device="cpu")
    init_opt, update = adamw.make_optimizer(
        schedules.cosine_schedule(1e-2, 10, 150), decay=PT.decay_mask(cfg))
    opt = init_opt(params)
    step = make_train_step(cfg, update)
    pipe = SyntheticLM(DataConfig(global_batch=8, seq_len=32, vocab=64),
                       device="cpu")
    losses = []
    for _ in range(150):
        params, opt, _, metrics = step(params, opt, None, next(pipe))
        losses.append(float(metrics["loss"]))
    # bigram data has ~log(8)=2.08 nats of true entropy; start is ~log(64)
    assert losses[0] > 3.5
    assert min(losses[-10:]) < losses[0] - 0.8, losses[::15]


def test_checkpoint_resume_bitexact(tmp_path):
    """Train 6 steps straight vs 3 + save + restore + 3: identical params."""
    cfg = _tiny_cfg()
    init_opt, update = adamw.make_optimizer(schedules.constant(1e-3),
                                            decay=PT.decay_mask(cfg))
    step = make_train_step(cfg, update)

    def fresh():
        p = PT.init_params(cfg, 0, device="cpu")
        return p, init_opt(p)

    dc = DataConfig(global_batch=4, seq_len=16, vocab=64)
    pa, oa = fresh()
    pipe = SyntheticLM(dc, device="cpu")
    for _ in range(6):
        pa, oa, _, _ = step(pa, oa, None, next(pipe))
    pb, ob = fresh()
    pipe_b = SyntheticLM(dc, device="cpu")
    for _ in range(3):
        pb, ob, _, _ = step(pb, ob, None, next(pipe_b))
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, {"p": pb, "o": ob}, extra={"data": pipe_b.state()})
    pc, oc = fresh()
    pipe_c = SyntheticLM(dc, device="cpu")
    _, state, extra = restore_latest(d, {"p": pc, "o": oc})
    pc, oc = state["p"], state["o"]
    pipe_c.restore(extra["data"])
    for _ in range(3):
        pc, oc, _, _ = step(pc, oc, None, next(pipe_c))
    _equal_tree(pa, pc)
    _equal_tree(oa, oc)


def test_grad_accum_matches_full_batch_and_the_reference():
    cfg = _tiny_cfg(compute_dtype=torch.float32)
    jcfg = JT.ModelConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=64, scan_chunk=16, attention_impl="dot", remat=False,
        compute_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = params_from_numpy(cfg, tree, device="cpu")
    jbatch = next(JSyntheticLM(JDataConfig(global_batch=8, seq_len=16,
                                           vocab=64)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss_full, grads_full = loss_and_grads(params, cfg, batch)
    loss_acc, grads_acc = _accum_grads(params, cfg, batch, n=4)
    assert float(loss_acc) == pytest.approx(float(loss_full), rel=1e-5)
    _close_tree(grads_acc, grads_full, rtol=1e-5)
    want_loss, want = jax.jit(j_accum_grads, static_argnums=(1, 3))(
        jax.tree.map(jnp.asarray, tree), jcfg, jbatch, 4)
    assert float(loss_acc) == pytest.approx(float(want_loss), rel=1e-5)
    _close_tree(grads_acc, params_from_numpy(
        cfg, jax.tree.map(np.asarray, want), device="cpu"))


def test_remat_changes_no_number():
    cfg = _tiny_cfg(compute_dtype=torch.float32)
    params = PT.init_params(cfg, 0, device="cpu")
    batch = next(SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                        vocab=64), device="cpu"))
    loss, grads = loss_and_grads(params, cfg, batch)
    loss_r, grads_r = loss_and_grads(
        params, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(loss, loss_r)
    _equal_tree(grads, grads_r)


def test_train_steps_equal_the_reference_from_one_state():
    """Three steps of the CLI's step (value_and_grad + AdamW on the cosine
    schedule) in each package from the same weights and batches."""
    jcfg = dataclasses.replace(jqwen.SMOKE, compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(pqwen.SMOKE, compute_dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    j_init, j_update = jadamw.make_optimizer(j_schedule("cosine", 20))
    init, update = adamw.make_optimizer(train_cli._schedule("cosine", 20),
                                        decay=PT.decay_mask(pcfg))

    @jax.jit
    def j_step(p, o, b):
        loss, grads = jax.value_and_grad(JT.loss_fn)(p, jcfg, b)
        new_p, new_o, metrics = j_update(grads, o, p)
        return new_p, new_o, {"loss": loss, **metrics}

    jp = jax.tree.map(jnp.asarray, tree)
    jo = j_init(jp)
    params = params_from_numpy(pcfg, tree, device="cpu")
    opt = init(params)
    step = make_train_step(pcfg, update)
    jpipe = JSyntheticLM(JDataConfig(global_batch=4, seq_len=16,
                                     vocab=pcfg.vocab))
    pipe = SyntheticLM(DataConfig(global_batch=4, seq_len=16,
                                  vocab=pcfg.vocab), device="cpu")
    for _ in range(3):
        jp, jo, want = j_step(jp, jo, next(jpipe))
        params, opt, _, got = step(params, opt, None, next(pipe))
        for key in ("loss", "lr", "grad_norm"):
            assert float(got[key]) == pytest.approx(float(want[key]),
                                                    rel=1e-5), key
    assert int(opt.step) == int(jo.step) == 3
    want = params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                             device="cpu")
    # a key bias adds one constant to each row of logits, which the softmax
    # cancels: its gradient is 0 up to rounding, and AdamW turns that noise
    # into steps of ~lr in both packages.  Its gradient is held in
    # tests/test_torch_train_grads.py; here it only has to stay that small
    noise = [(p, t) for p, t in tree_paths(params) if p[-1] == "bk"]
    assert noise and all(float(t.abs().max()) <= 3 * 3e-3 for _, t in noise)
    for layer in (*params["layers"], *want["layers"]):
        layer["attn"].pop("bk")
    _close_tree(params, want)


# ------------------------------------------------------------------- CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args], capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300)


def test_train_cli_runs_and_resumes(tmp_path):
    ck = str(tmp_path / "ckpt")
    base = ["--arch", "qwen2_1_5b", "--scale", "smoke", "--batch", "2",
            "--seq", "32", "--ckpt-dir", ck, "--ckpt-interval", "2",
            "--log-every", "2"]
    r = _cli(*base, "--steps", "6")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step     0 loss" in r.stdout and "gnorm" in r.stdout
    assert "done: 6 steps" in r.stdout
    # resume: starts from step 5 (last checkpoint), runs to 8
    r2 = _cli(*base, "--steps", "8")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[restore] resumed at step 5" in r2.stdout
    assert "done: 3 steps" in r2.stdout


def test_train_cli_compresses_and_accumulates(capsys):
    train_cli.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                    "--seq", "16", "--log-every", "1", "--grad-compression",
                    "int8", "--grad-accum", "2"])
    out = capsys.readouterr().out
    assert out.count(" loss ") == 2 and "done: 2 steps" in out


def test_train_cli_refuses_pod_meshes():
    for mesh in ("pod", "multipod"):
        with pytest.raises(NotImplementedError, match="item 9"):
            train_cli.main(["--device", "cpu", "--mesh", mesh])


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])
