"""Where the port's flash path places its queries, against the JAX package.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

The reference's ``attend`` places query i at key position i for every impl:
``dot`` and ``chunked`` by construction, ``pallas`` because its kernel
counts query positions from the block start.  The port's ``hopper`` impl
passes ``q_offset=0`` down to the kernel (on the CPU, to its plain version
``ref.attention_ref``), while ``ops.flash_attention`` keeps query ends
aligned with key ends by default.  Inputs come from numpy seeds and go
through both packages as numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

torch.set_num_threads(2)


def _smallest_case():
    """Causal, one query against two keys, only key 1's value non-zero:
    the query sees key 0 alone when it sits at position 0."""
    q = np.ones((1, 1, 1, 32), np.float32)
    k = np.zeros((1, 1, 2, 32), np.float32)
    v = np.zeros((1, 1, 2, 32), np.float32)
    v[:, :, 1] = 1.0
    return q, k, v


@pytest.mark.parametrize("impl", ["dot", "chunked", "hopper"])
def test_smallest_case_attends_key_zero_only(impl):
    q, k, v = _smallest_case()
    want = np.asarray(jattn.attend(*map(jnp.asarray, (q, k, v)),
                                   impl="chunked", causal=True))
    got = attention.attend(*map(torch.from_numpy, (q, k, v)), impl=impl,
                           causal=True)
    assert np.all(want == 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_smallest_case_matches_the_reference_pallas_impl():
    # the reference's kernel path (interpret mode on the CPU)
    q, k, v = _smallest_case()
    want = np.asarray(jattn.attend(*map(jnp.asarray, (q, k, v)),
                                   impl="pallas", causal=True))
    got = attention.attend(*map(torch.from_numpy, (q, k, v)), impl="hopper",
                           causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["dot", "chunked", "hopper"])
def test_attend_fewer_queries_than_keys(impl):
    # causal S=37 against T=100, GQA 4/2, D 32: every impl of the port
    # equals the reference's chunked impl within 1e-5
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, h, n, 32)).astype(np.float32)
               for h, n in ((4, 37), (2, 100), (2, 100)))
    want = np.asarray(jattn.attend(*map(jnp.asarray, (q, k, v)),
                                   impl="chunked", causal=True))
    got = attention.attend(*map(torch.from_numpy, (q, k, v)), impl=impl,
                           causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _masked_attention(q, k, v, mask):
    """Softmax attention with an explicit (S, T) mask, in float64; rows with
    nothing to attend are zeros."""
    hq, hk = q.shape[1], k.shape[1]
    k = np.repeat(k, hq // hk, axis=1).astype(np.float64)
    v = np.repeat(v, hq // hk, axis=1).astype(np.float64)
    logits = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), k)
    logits = np.where(mask, logits / np.sqrt(q.shape[-1]), -np.inf)
    top = logits.max(-1, keepdims=True)
    p = np.where(mask, np.exp(logits - np.where(np.isfinite(top), top, 0)),
                 0.0)
    den = p.sum(-1, keepdims=True)
    return np.einsum("bhst,bhtd->bhsd", p / np.where(den == 0, 1, den), v)


@pytest.mark.parametrize("q_offset,window", [
    (0, None), (63, None), (None, None), (-5, None), (80, None), (0, 16),
    (None, 16),
])
def test_attention_ref_q_offset_against_explicit_masks(q_offset, window):
    rng = np.random.default_rng(2)
    s, t = 37, 100
    q, k, v = (rng.standard_normal((1, h, n, 32)).astype(np.float32)
               for h, n in ((4, s), (2, t), (2, t)))
    off = t - s if q_offset is None else q_offset
    qpos = np.arange(s)[:, None] + off
    kpos = np.arange(t)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), _masked_attention(q, k, v, mask),
                               rtol=1e-5, atol=1e-5)
    # ops (the CPU route) passes the offset through and defaults to T - S
    via_ops = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, window=window,
                                  q_offset=q_offset)
    assert torch.equal(via_ops, got)
