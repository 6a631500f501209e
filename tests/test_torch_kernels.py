"""The port's kernels module on the CPU against the JAX package's oracles.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

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
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.lrn import lrn_cuda
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.pooling import pool_cuda

torch.set_num_threads(2)

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


# max pooling propagates NaN, as jax.lax.max does: a window with a NaN tap
# gives NaN; average pooling does through its sum.  "centre": the smallest
# case, one window around a NaN; "edge": a NaN in the row two windows share
_NAN_AT = {"centre": ((3, 3, 1), (1, 1, 0)), "edge": ((5, 5, 2), (2, 0, 1))}


@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("where", sorted(_NAN_AT))
def test_pool_propagates_nan(where, pool_type, via):
    shape, at = _NAN_AT[where]
    a = np.zeros((1, *shape), np.float32)
    a[(0, *at)] = np.nan
    jx, tx = _pair(a, "float32")
    if via == "ops":
        got = ops.pool(tx, window=3, stride=2, pool_type=pool_type)
    else:
        fn = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
        got = fn(tx, window=3, stride=2)
    jfn = jref.maxpool_ref if pool_type == "max" else jref.avgpool_ref
    want = np.asarray(jfn(jx, window=3, stride=2))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    _assert_close(got, want, "float32")


# ------------------------------------------------------------------ lrn
# the window is [c - n//2, c - n//2 + n) for odd and even n, zero-padded:
# even windows (4, 2), a window of one, and one wider than C (7 > 4)
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("c,local", [(8, 5), (16, 3), (96, 5), (7, 5),
                                     (12, 4), (6, 2), (5, 1), (4, 7)])
def test_lrn_shapes(rng, c, local, via):
    jx, tx = _pair(rng.normal(size=(2, 7, 7, c)), "float32")
    fn = ref.lrn_ref if via == "ref" else ops.lrn
    _assert_close(fn(tx, local_size=local),
                  jref.lrn_ref(jx, local_size=local), "float32")


@pytest.mark.parametrize("case", ["lrn-n4", "maxpool-nan"])
def test_smallest_cases_match_the_pallas_kernels(case):
    # the JAX package's Pallas kernels themselves, in interpret mode, at the
    # smallest inputs that tell an n + 1 LRN window and a NaN-dropping max
    # from the reference's
    from repro.kernels.lrn import lrn_pallas
    from repro.kernels.pooling import pool_pallas

    if case == "lrn-n4":
        a = (np.random.default_rng(0).normal(size=(1, 1, 1, 6)) * 30
             ).astype(np.float32)
        jx, tx = _pair(a, "float32")
        want = np.asarray(lrn_pallas(jx, local_size=4, interpret=True))
        got = ops.lrn(tx, local_size=4)
    else:
        a = np.zeros((1, 3, 3, 1), np.float32)
        a[0, 1, 1, 0] = np.nan
        jx, tx = _pair(a, "float32")
        want = np.asarray(pool_pallas(jx, window=3, stride=2,
                                      pool_type="max", interpret=True))
        got = ops.pool(tx, window=3, stride=2, pool_type="max")
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    _assert_close(got, want, "float32")


def test_lrn_default_k_is_two(rng):
    # the JAX package's LRN constant, not F.local_response_norm's k=1
    x = torch.from_numpy(rng.normal(size=(1, 2, 2, 6)).astype(np.float32))
    want = ref.lrn_ref(x, k=2.0)
    assert torch.equal(ops.lrn(x), want)
    assert not torch.allclose(ref.lrn_ref(x, k=1.0), want)


# ------------------------------------------------------ flash attention
# the plain versions are held at the tolerance of the inputs' dtype; the
# JAX package holds its online-softmax kernel at bf16 tolerance, which
# chip_smoke.py applies to the CUDA kernel on the card
@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hk", [(8, 8), (8, 2), (4, 1)])
def test_attention_gqa(rng, hq, hk, dtype, via):
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(2, h, 256, 64)), dtype) for h in (hq, hk, hk))
    fn = ref.attention_ref if via == "ref" else ops.flash_attention
    got = fn(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_close(got, jref.attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("window", [32, 64, 250])
def test_attention_windowed(rng, window, via):
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(1, h, 256, 32)), "float32") for h in (4, 2, 2))
    fn = ref.attention_ref if via == "ref" else ops.flash_attention
    _assert_close(fn(tq, tk, tv, causal=True, window=window),
                  jref.attention_ref(jq, jk, jv, causal=True, window=window),
                  "float32")


@pytest.mark.parametrize("s,t", [(100, 100), (37, 100), (1, 100)])
def test_attention_aligns_query_ends(s, t):
    # unaligned lengths, and fewer queries than keys (decode-style): query i
    # sits at position i + t - s in both packages
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(1, 2, n, 32)), "float32") for n in (s, t, t))
    _assert_close(ops.flash_attention(tq, tk, tv, causal=True),
                  jref.attention_ref(jq, jk, jv, causal=True), "float32")


def test_attention_fully_masked_rows_are_zero():
    # more queries than keys: the first s - t queries sit before every key
    q, k, v = (torch.ones(1, 2, n, 32) for n in (8, 3, 3))
    out = ref.attention_ref(q, k, v, causal=True)
    assert torch.equal(out[:, :, :5], torch.zeros(1, 2, 5, 32))
    assert torch.isfinite(out).all()


# ------------------------------------------------------ paged attention
def _paged_case(rng, *, b, hq, hk, d, bs, nb, dtype):
    """tests/test_kernels.py's decode case: an arena of shuffled physical
    pages + a trash page, and per-slot positions anywhere in the table."""
    tb = b * nb + 1
    q = rng.normal(size=(b, hq, 1, d))
    ka = rng.normal(size=(tb, hk, bs, d))
    va = rng.normal(size=(tb, hk, bs, d))
    ids = rng.permutation(np.arange(tb - 1) + 1)
    bt = ids[:b * nb].reshape(b, nb).astype(np.int32)
    pos = rng.integers(0, nb * bs, size=(b,)).astype(np.int32)
    jt = [_pair(a, dtype) for a in (q, ka, va)]
    return ([x[0] for x in jt] + [jnp.asarray(bt), jnp.asarray(pos)],
            [x[1] for x in jt] + [torch.from_numpy(bt),
                                  torch.from_numpy(pos)])


@pytest.mark.parametrize("via", ["ref", "ops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hk", [(8, 8), (8, 2), (4, 1), (12, 2)])
def test_paged_attention_gqa(rng, hq, hk, dtype, via):
    jargs, targs = _paged_case(rng, b=3, hq=hq, hk=hk, d=64, bs=16, nb=4,
                               dtype=dtype)
    fn = ref.paged_attention_ref if via == "ref" else ops.paged_attention
    got = fn(*targs)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    _assert_close(got, jref.paged_attention_ref(*jargs), dtype)


@pytest.mark.parametrize("pos_list", [[0], [15], [16], [17], [63]])
def test_paged_attention_block_boundaries(rng, pos_list):
    jargs, targs = _paged_case(rng, b=len(pos_list), hq=4, hk=2, d=32, bs=16,
                               nb=4, dtype="float32")
    pos = np.asarray(pos_list, np.int32)
    jargs[-1], targs[-1] = jnp.asarray(pos), torch.from_numpy(pos)
    _assert_close(ops.paged_attention(*targs),
                  jref.paged_attention_ref(*jargs), "float32")


def test_paged_gather_trims_sequence_overhang(rng):
    # max_seq not a multiple of block_size: the gathered rows are those of
    # a dense cache of exactly max_seq, bit for bit
    jargs, targs = _paged_case(rng, b=2, hq=4, hk=2, d=32, bs=8, nb=3,
                               dtype="float32")
    got = ref.paged_gather(targs[1], targs[3], 21)
    assert got.shape == (2, 2, 21, 32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.paged_gather(jargs[1], jargs[3], 21)))
    pos = np.array([5, 20], np.int32)
    jargs[-1], targs[-1] = jnp.asarray(pos), torch.from_numpy(pos)
    _assert_close(ref.paged_attention_ref(*targs, max_seq=21),
                  jref.paged_attention_ref(*jargs, max_seq=21), "float32")


# ------------------------------------------------- kernel wrappers on CPU
@pytest.mark.parametrize("name", ["matmul", "conv2d", "pool", "lrn",
                                  "paged_attention", "flash_attention"])
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
        "paged_attention": (paged_attention_cuda, lambda: paged_attention_cuda(
            torch.zeros(1, 4, 1, 32), torch.zeros(3, 2, 8, 32),
            torch.zeros(3, 2, 8, 32), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))),
        "flash_attention": (flash_attention_cuda, lambda: flash_attention_cuda(
            torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32),
            torch.zeros(1, 2, 8, 32))),
    }
    wrapper, call = calls[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert wrapper.launches == before
