"""The port's kernels module on the CPU against the JAX package's oracles.

On a CPU tensor every wrapper in ``repro_torch.kernels.ops`` runs the plain
PyTorch version in ``repro_torch.kernels.ref``; both are held here against
``repro.kernels.ref`` on the same numpy-seeded inputs, at the shapes and
tolerances of tests/test_kernels.py (which holds the Pallas kernels to the
same oracles).  The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import engines
from repro_torch.core.layer_model import FCSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d import conv2d_cuda
from repro_torch.kernels.lrn import lrn_cuda
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.pooling import pool_cuda

_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)))


def _assert_close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


# ---------------------------------------------------------------- matmul
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128), (256, 512, 256), (100, 300, 70), (1, 9216, 4096),
    (8, 64, 8),
])
def test_matmul_shapes(rng, m, k, n, dtype, via):
    # weights scaled by 1/sqrt(k), as a layer's are: with unit weights the
    # (1, 9216, 4096) outputs reach ~100 and two correct fp32 summation
    # orders (PyTorch's and XLA's CPU GEMMs) differ by ~3e-4 near zero
    jx, tx = _pair(rng.normal(size=(m, k)), dtype)
    jw, tw = _pair(rng.normal(size=(k, n)) / np.sqrt(k), dtype)
    got = ref.matmul_ref(tx, tw) if via == "ref" else ops.matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    _assert_close(got, jref.matmul_ref(jx, jw), dtype)


@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("activation",
                         ["none", "relu", "sigmoid", "tanh", "softmax"])
def test_fc_bias_activation(rng, activation, via):
    jx, tx = _pair(rng.normal(size=(64, 96)), "float32")
    jw, tw = _pair(rng.normal(size=(96, 48)), "float32")
    jb, tb = _pair(rng.normal(size=(48,)), "float32")
    fn = ref.fc_ref if via == "ref" else ops.fc
    _assert_close(fn(tx, tw, tb, activation=activation),
                  jref.fc_ref(jx, jw, jb, activation=activation), "float32")


def test_fc_flattens_nhwc(rng):
    # FC6 reads Pool5's (B, 6, 6, C) output flattened in (H, W, C) order;
    # the FC layer of either engine owns that flatten (ops.fc takes 2-D)
    jx, tx = _pair(rng.normal(size=(2, 3, 3, 4)), "float32")
    jw, tw = _pair(rng.normal(size=(36, 5)), "float32")
    want = jref.fc_ref(jx.reshape(2, -1), jw, activation="relu")
    spec = FCSpec("FC", m_i=(4, 3, 3), k_o=5, activation="relu")
    for engine in (engines.TORCH_ENGINE, engines.HOPPER_ENGINE):
        _assert_close(engine.build(spec)(tx, {"w": tw}), want, "float32")


# ---------------------------------------------------------------- conv2d
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,cin,cout,kk,stride,pad", [
    (16, 3, 8, 3, 1, 1),
    (16, 4, 8, 3, 2, 0),
    (24, 3, 16, 5, 2, 2),
    (13, 8, 16, 3, 1, 1),      # conv3-5 geometry (reduced channels)
    (12, 3, 8, 11, 4, 2),      # conv1 geometry (reduced)
])
def test_conv2d_shapes(rng, hw, cin, cout, kk, stride, pad, dtype, via):
    jx, tx = _pair(rng.normal(size=(2, hw, hw, cin)), dtype)
    jw, tw = _pair(rng.normal(size=(cout, cin, kk, kk)), dtype)
    jb, tb = _pair(rng.normal(size=(cout,)), dtype)
    fn = ref.conv2d_ref if via == "ref" else ops.conv2d
    got = fn(tx, tw, tb, stride=stride, padding=pad, activation="relu")
    assert got.is_contiguous() and got.dtype == tx.dtype
    _assert_close(got, jref.conv2d_ref(jx, jw, jb, stride=stride,
                                       padding=pad, activation="relu"),
                  dtype)


# --------------------------------------------------------------- pooling
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("hw,c,win,stride", [
    (13, 8, 3, 2), (27, 4, 3, 2), (8, 16, 2, 2), (9, 3, 3, 3),
])
def test_pool_shapes(rng, hw, c, win, stride, pool_type, via):
    jx, tx = _pair(rng.normal(size=(2, hw, hw, c)), "float32")
    if via == "ops":
        got = ops.pool(tx, window=win, stride=stride, pool_type=pool_type)
    else:
        fn = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
        got = fn(tx, window=win, stride=stride)
    jfn = jref.maxpool_ref if pool_type == "max" else jref.avgpool_ref
    assert got.is_contiguous()
    _assert_close(got, jfn(jx, window=win, stride=stride), "float32")


# ------------------------------------------------------------------ lrn
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("c,local", [(8, 5), (16, 3), (96, 5), (7, 5)])
def test_lrn_shapes(rng, c, local, via):
    jx, tx = _pair(rng.normal(size=(2, 7, 7, c)), "float32")
    fn = ref.lrn_ref if via == "ref" else ops.lrn
    _assert_close(fn(tx, local_size=local),
                  jref.lrn_ref(jx, local_size=local), "float32")


def test_lrn_default_k_is_two(rng):
    # the JAX package's LRN constant, not F.local_response_norm's k=1
    x = torch.from_numpy(rng.normal(size=(1, 2, 2, 6)).astype(np.float32))
    want = ref.lrn_ref(x, k=2.0)
    assert torch.equal(ops.lrn(x), want)
    assert not torch.allclose(ref.lrn_ref(x, k=1.0), want)


# ------------------------------------------------- kernel wrappers on CPU
@pytest.mark.parametrize("name", ["matmul", "conv2d", "pool", "lrn"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    x4 = torch.zeros(1, 8, 8, 4)
    calls = {
        "matmul": (matmul_cuda, lambda: matmul_cuda(torch.zeros(2, 3),
                                                    torch.zeros(3, 4))),
        "conv2d": (conv2d_cuda, lambda: conv2d_cuda(x4,
                                                    torch.zeros(2, 4, 3, 3))),
        "pool": (pool_cuda, lambda: pool_cuda(x4)),
        "lrn": (lrn_cuda, lambda: lrn_cuda(x4)),
    }
    wrapper, call = calls[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert wrapper.launches == before
