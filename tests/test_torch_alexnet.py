"""The port's AlexNet, end to end on the CPU, against the JAX package's.

Weights come from the JAX package's own init (PRNGKey(0)) and cross through
``params_from_numpy``; inputs are numpy-seeded.  The reference runs on its
``xla`` engine; the port runs its plain versions, as it does for any CPU
tensor.  Every layer's output is held to the reference's, each within
LAYER_RTOL of its own largest magnitude, and the log-probabilities within
LOGP_ATOL; both limits are about 8x the largest difference measured on the
CPU (2.6e-6 relative in a layer, 1.7e-5 in a log-probability, full width at
batch 2), so a logit off by 1e-3 fails.  The probabilities are also held at
the tolerance of tests/test_core_cnnlab.py's engine-agreement test
(rtol 2e-3 / atol 2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.layer_model as jlm
from repro.core import engines as jeng
from repro.core import plan as jplan
from repro.core import scheduler as jsched
from repro.models.alexnet import AlexNet as JaxAlexNet
from repro_torch.core import engines, layer_model as lm
from repro_torch.models.alexnet import AlexNet
from repro_torch.models.convert import params_from_numpy

RTOL, ATOL = 2e-3, 2e-4
LAYER_RTOL, LOGP_ATOL = 2e-5, 1e-4


def _reduced_alexnet(mod):
    """examples/cnnlab_alexnet.py's 32x32 network, in either package."""
    return mod.NetworkSpec("alexnet-reduced", (
        mod.ConvSpec("Conv1", m_i=(32, 32, 3), m_k=(16, 3, 5, 5),
                     m_o=(16, 16, 16), stride=2, padding=2),
        mod.NormSpec("LRN1", m_i=(16, 16, 16), norm_type="lrn", local_size=5),
        mod.PoolSpec("Pool1", m_i=(16, 16, 16), m_o=(7, 7, 16), window=3,
                     stride=2),
        mod.ConvSpec("Conv2", m_i=(7, 7, 16), m_k=(32, 16, 3, 3),
                     m_o=(7, 7, 32), stride=1, padding=1),
        mod.PoolSpec("Pool2", m_i=(7, 7, 32), m_o=(3, 3, 32), window=3,
                     stride=2),
        mod.FCSpec("FC6", m_i=(32, 3, 3), k_o=128, activation="relu"),
        mod.FCSpec("FC8", m_i=(128,), k_o=10, activation="softmax"),
    ))


def _jax_params(net):
    params = jplan.init_network_params(net, jax.random.PRNGKey(0))
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _jax_activations(jnet, arrays, x):
    """Every layer's output of the reference's xla engine, chained as its
    compile_plan chains them."""
    outs, h = [], jnp.asarray(x)
    for spec, p in zip(jnet, arrays):
        h = jeng.XLA_ENGINE.build(spec)(
            h, {k: jnp.asarray(v) for k, v in p.items()})
        outs.append(np.asarray(h))
    return outs


def _assert_layers_close(net, got, want):
    for spec, g, w in zip(list(net)[:-1], got[:-1], want[:-1]):
        assert g.shape == w.shape, spec.name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= LAYER_RTOL, f"{spec.name}: relative error {err:.2e}"
    np.testing.assert_allclose(np.log(got[-1]), np.log(want[-1]), rtol=0,
                               atol=LOGP_ATOL)


@pytest.fixture(scope="module")
def full_case():
    rng = np.random.default_rng(0)
    arrays = _jax_params(jlm.alexnet_full_spec())
    x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(JaxAlexNet(engines=(jeng.XLA_ENGINE,))(
        jnp.asarray(x), [{k: jnp.asarray(v) for k, v in p.items()}
                         for p in arrays]))
    return arrays, x, want, _jax_activations(jlm.alexnet_full_spec(),
                                             arrays, x)


@pytest.mark.parametrize("engine_set", ["default", "torch", "hopper"])
def test_full_alexnet_matches_jax(full_case, engine_set):
    arrays, x, want, want_acts = full_case
    net = lm.alexnet_full_spec()
    chosen = {"default": engines.DEFAULT_ENGINES,
              "torch": (engines.TORCH_ENGINE,),
              "hopper": (engines.HOPPER_ENGINE,)}[engine_set]
    model = AlexNet(device="cpu", engines=chosen,
                    params=params_from_numpy(net, arrays, device="cpu"))
    with torch.inference_mode():
        acts = [a.numpy() for a in model.activations(torch.from_numpy(x))]
    got = acts[-1]
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    _assert_layers_close(net, acts, want_acts)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_reduced_alexnet_matches_jax():
    rng = np.random.default_rng(1)
    jnet, net = _reduced_alexnet(jlm), _reduced_alexnet(lm)
    arrays = _jax_params(jnet)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jfn = jplan.compile_plan(jsched.schedule(jnet, [jeng.XLA_ENGINE]))
    want = np.asarray(jfn(jnp.asarray(x), [
        {k: jnp.asarray(v) for k, v in p.items()} for p in arrays]))
    want_acts = _jax_activations(jnet, arrays, x)
    params = params_from_numpy(net, arrays, device="cpu")
    outs = []
    for chosen in ((engines.TORCH_ENGINE,), (engines.HOPPER_ENGINE,)):
        model = AlexNet(device="cpu", net=net, engines=chosen, params=params)
        acts = [a.numpy() for a in model.activations(torch.from_numpy(x))]
        _assert_layers_close(net, acts, want_acts)
        outs.append(model(torch.from_numpy(x)).numpy())
        np.testing.assert_array_equal(outs[-1], acts[-1])
        np.testing.assert_allclose(outs[-1], want, rtol=RTOL, atol=ATOL)
    # on the CPU both engines run the same plain versions
    np.testing.assert_array_equal(outs[0], outs[1])


def test_plans_agree_on_cpu_with_seeded_init():
    net = _reduced_alexnet(lm)
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(3, 32, 32, 3)).astype(
            np.float32))
    a = AlexNet(device="cpu", net=net, engines=(engines.TORCH_ENGINE,))
    b = AlexNet(device="cpu", net=net, engines=(engines.HOPPER_ENGINE,))
    for pa, pb in zip(a.params(), b.params()):     # same seed, same weights
        assert pa.keys() == pb.keys()
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    assert a(x).shape == (3, 10)


def test_model_holds_plan_and_buffers():
    model = AlexNet(device="cpu")
    assert [a.engine for a in model.plan.assignments].count("hopper") == 1
    assert model.plan.engine_of("Conv2") == "hopper"
    assert sum(t.numel() for t in model.buffers()) == 62_378_344
    assert not list(model.parameters())           # inference: buffers only
    assert {t.device.type for t in model.buffers()} == {"cpu"}


def test_params_from_numpy_checks_shapes():
    net = _reduced_alexnet(lm)
    arrays = _jax_params(_reduced_alexnet(jlm))
    params = params_from_numpy(net, arrays, device="cpu")
    assert params[0]["w"].shape == (16, 3, 5, 5)
    assert params[0]["w"].dtype == torch.float32
    np.testing.assert_array_equal(params[5]["w"].numpy(), arrays[5]["w"])
    bad = [dict(p) for p in arrays]
    bad[5] = {"w": arrays[5]["w"].T, "b": arrays[5]["b"]}
    with pytest.raises(ValueError, match="FC6"):
        params_from_numpy(net, bad, device="cpu")
    with pytest.raises(ValueError, match="parameter dicts"):
        params_from_numpy(net, arrays[:-1], device="cpu")
    missing = [dict(p) for p in arrays]
    del missing[0]["b"]
    with pytest.raises(ValueError, match="Conv1"):
        params_from_numpy(net, missing, device="cpu")
