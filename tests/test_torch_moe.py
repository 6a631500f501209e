"""The port's MoE FFN (``models/moe.py``) against the JAX package's, on the
CPU in float32.

* ``capacity`` equals the JAX package's over a grid of lengths, expert
  counts, top-k and capacity factors.
* ``moe_apply`` agrees at SMOKE widths (phi3.5-MoE's: D 64, F 96, 4 experts,
  top-2) within the fp32 kernel tolerance of tests/test_kernels.py (2e-4),
  once where every routing slot fits its expert's capacity and once where a
  capacity factor of 0.25 over 64 tokens drops slots to the dump row.
* A one-layer MoE decoder agrees through ``decode_step_slots_paged``
  (impl ref) under a random active mask, at the same tolerance on the
  logits.

The same numpy arrays go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi35_moe as jcfgs
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import phi35_moe as pcfgs
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

ATOL = 2e-4                                   # tests/test_kernels.py fp32
ARGS = dict(d_model=64, d_ff=96, n_experts=4, top_k=2)


def _args(capacity_factor):
    return (jmoe.MoEArgs(**ARGS, capacity_factor=capacity_factor),
            pmoe.MoEArgs(**ARGS, capacity_factor=capacity_factor))


@pytest.fixture(scope="module")
def expert_params():
    jargs, _ = _args(1.25)
    tree = {k: np.asarray(v) for k, v in jmoe.init_moe_params(
        jax.random.PRNGKey(0), jargs).items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def test_capacity_matches_the_reference():
    for seq in (1, 2, 7, 8, 16, 63, 64, 100, 512, 4096):
        for e, k in ((4, 1), (4, 2), (8, 2), (16, 2)):
            for cf in (0.25, 1.0, 1.25, 2.0):
                jargs = jmoe.MoEArgs(64, 96, e, k, cf)
                pargs = pmoe.MoEArgs(64, 96, e, k, cf)
                assert pmoe.capacity(pargs, seq) == jmoe.capacity(jargs,
                                                                  seq)
    assert pmoe.capacity(pmoe.MoEArgs(4096, 6400, 16, 2), 1) == 8


def _routing(jargs, x):
    """Slots the JAX package's routing keeps, of the B·S·K."""
    b, s, _ = x.shape
    cap = jmoe.capacity(jargs, s)
    logits = np.asarray(x, np.float64) @ np.asarray(
        jmoe.init_moe_params(jax.random.PRNGKey(0), jargs)["router"],
        np.float64)
    idx = np.argsort(-logits, axis=-1)[..., :jargs.top_k].reshape(b, -1)
    kept = 0
    for row in idx:
        counts = np.zeros(jargs.n_experts, int)
        for e in row:
            kept += counts[e] < cap
            counts[e] += 1
    return kept, idx.size


@pytest.mark.parametrize("capacity_factor,seq", [(1.25, 16), (0.25, 64)],
                         ids=["no-drops", "drops"])
def test_moe_apply_matches_the_reference(expert_params, capacity_factor,
                                         seq):
    jargs, pargs = _args(capacity_factor)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, seq, ARGS["d_model"])).astype(np.float32)
    kept, total = _routing(jargs, x)
    if capacity_factor > 1:
        assert kept == total
    else:
        assert kept < total          # over-capacity slots reach the dump
    want = jmoe.moe_apply(expert_params[0], jnp.asarray(x), jargs,
                          jnp.float32)
    got = pmoe.moe_apply(expert_params[1], torch.from_numpy(x), pargs,
                         torch.float32)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_moe_block_matches_through_the_paged_slot_step():
    jcfg = dataclasses.replace(jcfgs.SMOKE, n_layers=1,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(pcfgs.SMOKE, n_layers=1,
                               compute_dtype=torch.float32)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(1),
                                                   jcfg))

    def redraw(path, a):      # norms start at zero: give them values
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name == "final_norm":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    pparams = params_from_numpy(pcfg, tree, device="cpu")
    assert pparams["layers"][0]["mlp"]["w_down"].shape == (4, 96, 64)
    n_slots, max_seq, bs = 3, 16, 4
    jcache = JT.init_slot_cache_paged(jcfg, n_slots, max_seq, block_size=bs)
    pcache = PT.init_slot_cache_paged(pcfg, n_slots, max_seq, block_size=bs,
                                      device="cpu")
    tables = np.arange(n_slots * 4, dtype=np.int32)[::-1].reshape(n_slots, 4)
    jcache["block_tables"] = jnp.asarray(tables)
    pcache["block_tables"].copy_(torch.from_numpy(tables.copy()))
    step = jax.jit(lambda p, c, t, a: JT.decode_step_slots_paged(
        p, jcfg, c, t, a, max_seq=max_seq))
    jparams = jax.tree.map(jnp.asarray, tree)
    for _ in range(10):
        t = rng.integers(0, pcfg.vocab, size=(n_slots, 1), dtype=np.int32)
        active = rng.random(n_slots) < 0.8
        want, jcache = step(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(active))
        got, pcache = PT.decode_step_slots_paged(
            pparams, pcfg, pcache, torch.from_numpy(t),
            torch.from_numpy(active), max_seq=max_seq)
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
