"""The port's state-space blocks (``models/ssm.py``) against the JAX
package's, on the CPU in float32.

``mamba_apply``/``rglru_apply`` with ``return_state`` (output and state),
``mamba_step``/``rglru_step`` from a random state, and a prefill state
followed by three steps, at one scan chunk (L = chunk) and at several
(L = 3 chunks, the state carried across chunk boundaries).  Outputs and
recurrent states are held at the fp32 kernel tolerance of
tests/test_kernels.py, 2e-4 absolute; the conv state, stored in bfloat16
by both packages, must be bitwise equal (the two frameworks' fp32 inputs to
that rounding agree to ~1e-7 here, so no bfloat16 step of 2^-8 relative is
crossed, and the tolerance needs no widening for it).  The port runs the
segment scan as a doubling (Hillis-Steele) scan, the JAX package as
``associative_scan``; the two sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as pssm

torch.set_num_threads(2)

ATOL = 2e-4                                   # tests/test_kernels.py fp32
D, CHUNK = 64, 16


def _mamba():
    return (jssm.MambaArgs(D, 8, 4, 2, CHUNK),
            pssm.MambaArgs(D, 8, 4, 2, CHUNK))


def _rglru():
    return (jssm.RGLRUArgs(D, 4, 1, chunk=CHUNK),
            pssm.RGLRUArgs(D, 4, 1, chunk=CHUNK))


BLOCKS = {
    "mamba": (_mamba, jssm.init_mamba_params, jssm.mamba_apply,
              jssm.mamba_step, pssm.mamba_apply, pssm.mamba_step,
              pssm.mamba_param_shapes),
    "rglru": (_rglru, jssm.init_rglru_params, jssm.rglru_apply,
              jssm.rglru_step, pssm.rglru_apply, pssm.rglru_step,
              pssm.rglru_param_shapes),
}


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def block(request):
    args, init, japply, jstep, papply, pstep, shapes = BLOCKS[request.param]
    jargs, pargs = args()
    rng = np.random.default_rng(0)
    tree = {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(0),
                                              jargs).items()}
    # biases start at zero: give them values
    for name in ("conv_b", "b_a", "b_i"):
        if name in tree:
            tree[name] = (0.1 * rng.standard_normal(tree[name].shape)
                          ).astype(np.float32)
    assert {k: v.shape for k, v in tree.items()} == shapes(pargs)
    pp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    return dict(
        name=request.param, jargs=jargs,
        jp={k: jnp.asarray(v) for k, v in tree.items()},
        japply=jax.jit(lambda p, x: japply(p, x, jargs, jnp.float32,
                                           return_state=True)),
        jstep=jax.jit(lambda p, x, s: jstep(p, x, s, jargs, jnp.float32)),
        papply=lambda x: papply(pp, x, pargs, torch.float32,
                                return_state=True),
        pstep=lambda x, s: pstep(pp, x, s, pargs, torch.float32))


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _same_conv(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _state(s):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k == "conv" else torch.float32)
        for k, v in s.items()}


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_full_sequence_and_state_match(block, n_chunks):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n_chunks * CHUNK, D)).astype(np.float32)
    want, wstate = block["japply"](block["jp"], jnp.asarray(x))
    got, gstate = block["papply"](torch.from_numpy(x))
    _close(got, want)
    _close(gstate["h"], wstate["h"])
    _same_conv(gstate["conv"], wstate["conv"])


def test_full_sequence_refuses_a_ragged_length(block):
    x = torch.zeros((1, CHUNK + 3, D))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        block["papply"](x)


def test_step_matches_from_a_random_state(block):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, D)).astype(np.float32)
    init = (jssm.mamba_init_state if block["name"] == "mamba"
            else jssm.rglru_init_state)(block["jargs"], 3)
    state = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                            ).astype(v.dtype) for k, v in init.items()}
    want, wnew = block["jstep"](block["jp"], jnp.asarray(x), state)
    pstate = _state(state)
    saved = {k: v.clone() for k, v in pstate.items()}
    got, gnew = block["pstep"](torch.from_numpy(x), pstate)
    _close(got, want)
    _close(gnew["h"], wnew["h"])
    _same_conv(gnew["conv"], wnew["conv"])
    assert all(torch.equal(pstate[k], saved[k]) for k in saved)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_prefill_state_then_steps_match(block, n_chunks):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, n_chunks * CHUNK, D)).astype(np.float32)
    _, wstate = block["japply"](block["jp"], jnp.asarray(x))
    _, gstate = block["papply"](torch.from_numpy(x))
    for _ in range(3):
        t = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, wstate = block["jstep"](block["jp"], jnp.asarray(t), wstate)
        got, gstate = block["pstep"](torch.from_numpy(t), gstate)
        _close(got, want)
        _close(gstate["h"], wstate["h"])
        _same_conv(gstate["conv"], wstate["conv"])
