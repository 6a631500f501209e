"""The port's training loss and gradients against the JAX package's, on the
CPU at SMOKE width in float32.

* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of the
  JAX package's ``loss_fn`` for qwen2 (``dot``, and ``chunked`` over two
  key chunks), phi3.5-MoE, falcon-mamba and recurrentgemma, from the same
  weights (the JAX package's init, norms and biases redrawn from a numpy
  seed so that they matter) and the same batch; the JAX package's
  gradients come into the port's layout through ``params_from_numpy``.
  Each leaf is held within GRAD_RTOL of its largest magnitude (the fp32
  tolerance of tests/test_kernels.py).
* ``ChunkedAttention``'s dq, dk and dv against the JAX package's custom
  VJP (``_cv_bwd``) for causal, windowed and full attention with a GQA
  group of 2 and a short last key chunk, and against ``dot``'s autograd.
* ``softmax_cross_entropy`` with and without a mask, and
  ``aux_load_balance_loss``, against the JAX package's.
* A gradient through the ``hopper`` impl raises: the flash kernel has no
  backward in either package.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

GRAD_RTOL = 2e-4
BATCH, SEQ = 2, 32
_REDRAWN = ("final_norm", "bq", "bk", "bv", "conv_b", "b_a", "b_i")
CASES = {
    "qwen2-dot": ("qwen2_1_5b", {}),
    "qwen2-chunked": ("qwen2_1_5b", {"attention_impl": "chunked",
                                     "attn_chunk": SEQ // 2}),
    "phi35-moe": ("phi35_moe", {}),
    "falcon-mamba": ("falcon_mamba_7b", {}),
    "recurrentgemma": ("recurrentgemma_2b", {}),
}


def _configs(arch, **fields):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    pmod = importlib.import_module(f"repro_torch.configs.{arch}")
    return (dataclasses.replace(jmod.SMOKE, compute_dtype=jnp.float32,
                                **fields),
            dataclasses.replace(pmod.SMOKE, compute_dtype=torch.float32,
                                **fields))


def _weights(jcfg, seed=0):
    """The JAX package's init, norms and biases redrawn (numpy leaves)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))

    def redraw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name in _REDRAWN:
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}


def _close_tree(got, want, rtol=GRAD_RTOL):
    """Each leaf of ``got`` within rtol of ``want``'s largest magnitude."""
    gpaths, wpaths = tree_paths(got), tree_paths(want)
    assert [p for p, _ in gpaths] == [p for p, _ in wpaths]
    for (path, g), (_, w) in zip(gpaths, wpaths):
        g, w = g.detach().float().numpy(), w.detach().float().numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_leaf_equal_the_reference(case):
    arch, fields = CASES[case]
    jcfg, pcfg = _configs(arch, **fields)
    tree = _weights(jcfg)
    batch = _batch(pcfg.vocab)
    want_loss, want_grads = jax.jit(jax.value_and_grad(JT.loss_fn),
                                    static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(pcfg, tree, device="cpu")
    loss, grads = loss_and_grads(
        params, pcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = params_from_numpy(pcfg, jax.tree.map(np.asarray, want_grads),
                             device="cpu")
    _close_tree(grads, want)
    # the parameters are left alone and hold no graph
    assert not any(t.requires_grad for _, t in tree_paths(params))


# ---------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------
@pytest.mark.parametrize("causal, window", [(True, None), (True, 12),
                                            (False, None)])
def test_chunked_backward_equals_the_reference_vjp(causal, window):
    """S 40 over key chunks of 16 (the last is 8 long), 4 query heads over
    2 KV heads."""
    rng = np.random.default_rng(3)
    b, hq, hk, s, d, chunk = 2, 4, 2, 40, 16, 16
    q, dout = (rng.standard_normal((b, hq, s, d), np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, hk, s, d), np.float32) for _ in range(2))

    def jfn(q, k, v):
        return jattn.chunked_attention(q, k, v, causal=causal, window=window,
                                       kv_chunk=chunk)

    want_out, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = vjp(jnp.asarray(dout))

    def port(impl):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = pattn.attend(*leaves, impl=impl, causal=causal, window=window,
                           kv_chunk=chunk)
        out.backward(torch.from_numpy(dout))
        return out.detach(), [t.grad for t in leaves]

    out, grads = port("chunked")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=GRAD_RTOL * np.abs(want_out).max())
    for name, g, w in zip("qkv", grads, want):
        assert g.shape == w.shape, name           # exactly T key rows
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)
    _, dot_grads = port("dot")
    for name, g, w in zip("qkv", grads, dot_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_RTOL * w.abs().max().item(),
                                   err_msg=name)


def test_chunked_forward_keeps_its_numbers_without_grad():
    """Under no_grad the Function's forward is the loop it replaced: the
    same output whether or not a gradient is being recorded."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 4, 24, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 24, 16), np.float32))
    with torch.no_grad():
        plain = pattn.chunked_attention(q, k, k, kv_chunk=8)
    traced = pattn.chunked_attention(q.requires_grad_(), k, k, kv_chunk=8)
    assert torch.equal(plain, traced.detach())


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_equals_the_reference(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 50), np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    want, want_grad = jax.value_and_grad(jlayers.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_()
    got = players.softmax_cross_entropy(
        x, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-8)


def test_softmax_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros((2, 3, 5))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(players.softmax_cross_entropy(
        logits, labels, torch.zeros((2, 3)))) == 0.0


def test_aux_load_balance_loss_equals_the_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 4), np.float32)
    gate_idx = np.argsort(-logits, axis=-1)[..., :2].astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                      jnp.asarray(gate_idx), 4)
    got = pmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(gate_idx), 4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------
# the kernel impl has no backward
# ---------------------------------------------------------------------
def test_gradient_through_the_hopper_impl_raises():
    _, pcfg = _configs("qwen2_1_5b", attention_impl="hopper")
    params = PT.init_params(pcfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg.vocab).items()}
    with pytest.raises(NotImplementedError, match="has no backward"):
        loss_and_grads(params, pcfg, batch)
    with torch.no_grad():                  # forward only: allowed
        assert torch.isfinite(PT.loss_fn(params, pcfg, batch))
