"""The port's CNNLab core against the JAX package's, exactly.

Layer accounting, the cost model, the scheduler on the paper's engines and
the trade-off tables are pure arithmetic on the same inputs, so the port
must reproduce the reference's numbers bit for bit — not within a
tolerance.
"""
import dataclasses

import pytest

import repro.core.cost_model as jcost
import repro.core.device_models as jdm
import repro.core.engines as jeng
import repro.core.layer_model as jlm
import repro.core.scheduler as jsched
import repro.core.tradeoff as jtradeoff
from repro_torch.core import cost_model, device_models as dm, engines, \
    layer_model as lm, scheduler, tradeoff

_BATCHES = (1, 109)


def _specs(mod):
    """Every layer kind the layer model knows, built from one set of args."""
    return (list(mod.alexnet_full_spec()) + list(mod.alexnet_spec()) + [
        mod.NormSpec("LN", m_i=(1, 64, 512), norm_type="layernorm"),
        mod.NormSpec("RMS", m_i=(1, 64, 512), norm_type="rmsnorm"),
        mod.EmbeddingSpec("emb", vocab=32000, d_model=512),
        mod.AttentionSpec("attn", d_model=512, n_heads=8, n_kv_heads=2,
                          seq=128, kv_len=128, qkv_bias=True),
        mod.AttentionSpec("swa", d_model=512, n_heads=8, n_kv_heads=8,
                          seq=1, kv_len=4096, window=1024),
        mod.MLPSpec("mlp", d_model=512, d_ff=2048, seq=64, gated=True),
        mod.MLPSpec("ffn", d_model=512, d_ff=2048, seq=64, gated=False),
        mod.MoESpec("moe", d_model=512, d_ff=1024, seq=64, n_experts=8,
                    top_k=2),
        mod.SSMSpec("mamba", d_model=512, seq=64, variant="mamba1"),
        mod.SSMSpec("rglru", d_model=512, seq=64, variant="rglru"),
    ])


def _plan_rows(plan):
    return [(a.spec.name, a.engine, dataclasses.asdict(a.cost))
            for a in plan.assignments]


@pytest.mark.parametrize("batch", _BATCHES)
def test_layer_accounting_equals_reference(batch):
    for mine, theirs in zip(_specs(lm), _specs(jlm), strict=True):
        assert mine.kind == theirs.kind
        assert mine.flops(batch) == theirs.flops(batch), mine.name
        assert mine.bwd_flops(batch) == theirs.bwd_flops(batch), mine.name
        assert mine.param_count() == theirs.param_count(), mine.name
        for db in (2, 4):
            assert mine.param_bytes(db) == theirs.param_bytes(db)
            assert (mine.activation_bytes(batch, db)
                    == theirs.activation_bytes(batch, db)), mine.name


def test_alexnet_full_width():
    net = lm.alexnet_full_spec()
    assert len(net) == 13
    assert net.param_count() == 62_378_344
    assert net.param_count() == jlm.alexnet_full_spec().param_count()
    assert net.flops(1) == jlm.alexnet_full_spec().flops(1)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("batch", _BATCHES)
def test_layer_cost_equals_reference(batch, direction):
    for name, theirs_dev in jdm.REGISTRY.items():
        mine_dev = dm.REGISTRY[name]
        for mine, theirs in zip(_specs(lm), _specs(jlm), strict=True):
            for eff in (1.0, 0.55):
                a = cost_model.layer_cost(mine, mine_dev, batch=batch,
                                          direction=direction,
                                          mxu_efficiency=eff)
                b = jcost.layer_cost(theirs, theirs_dev, batch=batch,
                                     direction=direction, mxu_efficiency=eff)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                for obj in cost_model.OBJECTIVES:
                    assert (cost_model.objective_value(a, obj)
                            == jcost.objective_value(b, obj))


def test_cost_model_helpers_equal_reference():
    assert cost_model.OBJECTIVES == jcost.OBJECTIVES
    for a in (0.0, 0.3, 0.8, 1.0):
        for k in (1, 2, 4):
            assert (cost_model.expected_tokens_per_round(a, k)
                    == jcost.expected_tokens_per_round(a, k))
            assert (cost_model.speculative_decode_cost(1e-3, 5e-3, a, k)
                    == jcost.speculative_decode_cost(1e-3, 5e-3, a, k))
    xs, ys = [1.0, 4.0, 16.0], [2.0, 3.0, 9.0]
    for x in (0.5, 2.0, 10.0, 32.0):
        assert (cost_model.piecewise_interp(xs, ys, x)
                == jcost.piecewise_interp(xs, ys, x))
    t1 = cost_model.transfer_cost(1 << 20, dm.K40, dm.DE5)
    t2 = jcost.transfer_cost(1 << 20, jdm.K40, jdm.DE5)
    assert dataclasses.asdict(t1) == dataclasses.asdict(t2)


def _paper_engines(mod):
    return mod.PAPER_ENGINES + (mod.K40_CUDNN_ENGINE, mod.K40_CUBLAS_ENGINE)


@pytest.mark.parametrize("batch", _BATCHES)
@pytest.mark.parametrize("objective", cost_model.OBJECTIVES)
def test_schedule_on_paper_engines_equals_reference(objective, batch):
    for net_fn in ("alexnet_full_spec", "alexnet_spec"):
        for cap in (None, 10.0):
            mine = scheduler.schedule(
                getattr(lm, net_fn)(), _paper_engines(engines),
                objective=objective, batch=batch, power_cap_w=cap)
            theirs = jsched.schedule(
                getattr(jlm, net_fn)(), _paper_engines(jeng),
                objective=objective, batch=batch, power_cap_w=cap)
            assert _plan_rows(mine) == _plan_rows(theirs)
            assert mine.total_objective() == theirs.total_objective()
            assert mine.total_time == theirs.total_time
            assert mine.total_energy == theirs.total_energy
            assert [(a, b, dataclasses.asdict(c))
                    for a, b, c in mine.offload_overhead()] == \
                [(a, b, dataclasses.asdict(c))
                 for a, b, c in theirs.offload_overhead()]


@pytest.mark.parametrize("objective", cost_model.OBJECTIVES)
def test_exhaustive_schedule_equals_reference(objective):
    mine = scheduler.schedule_exhaustive(
        lm.NetworkSpec("sub", tuple(lm.alexnet_full_spec())[:5]),
        _paper_engines(engines), objective=objective)
    theirs = jsched.schedule_exhaustive(
        jlm.NetworkSpec("sub", tuple(jlm.alexnet_full_spec())[:5]),
        _paper_engines(jeng), objective=objective)
    assert _plan_rows(mine) == _plan_rows(theirs)
    greedy = scheduler.schedule(
        lm.NetworkSpec("sub", tuple(lm.alexnet_full_spec())[:5]),
        engines.ALL_ENGINES, objective=objective)
    best = scheduler.schedule_exhaustive(
        lm.NetworkSpec("sub", tuple(lm.alexnet_full_spec())[:5]),
        engines.ALL_ENGINES, objective=objective)
    assert greedy.total_objective() == pytest.approx(best.total_objective())


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("batch", (1, 16, 109))
def test_tradeoff_analysis_equals_reference(batch, direction):
    names = ("nvidia-k40", "altera-de5", "k40-cublas", "k40-cudnn")
    for net_fn in ("alexnet_full_spec", "alexnet_spec"):
        mine = tradeoff.analyze(getattr(lm, net_fn)(),
                                [dm.REGISTRY[n] for n in names],
                                batch=batch, direction=direction)
        theirs = jtradeoff.analyze(getattr(jlm, net_fn)(),
                                   [jdm.REGISTRY[n] for n in names],
                                   batch=batch, direction=direction)
        assert [dataclasses.asdict(r) for r in mine] == \
            [dataclasses.asdict(r) for r in theirs]


@pytest.mark.parametrize("batch", (tradeoff.PAPER_WORKLOAD_IMAGES, 16))
def test_paper_claims_equal_reference(batch):
    mine = tradeoff.check_paper_claims(batch)
    assert mine == jtradeoff.check_paper_claims(batch)
    if batch == tradeoff.PAPER_WORKLOAD_IMAGES:
        assert all(c["ok"] for c in mine.values())


# ----------------------------------------------------- the port's own parts
def test_h100_model_is_the_datasheet_and_separate():
    h = dm.H100
    assert (h.peak_flops, h.mem_bw, h.power_active) == (989e12, 3.35e12,
                                                        700.0)
    assert h.analytic and dm.get("nvidia-h100") is h
    assert "nvidia-h100" not in jdm.REGISTRY      # reference registry as-is
    for engine in engines.DEFAULT_ENGINES:
        assert engine.device is h and engine.buildable
    assert [e.efficiency for e in engines.DEFAULT_ENGINES] == [
        e.efficiency for e in jeng.DEFAULT_ENGINES]


@pytest.mark.parametrize("batch,on_kernels", [
    (1, {"Conv2"}),
    (4, {"Conv2", "Conv3", "Conv4", "Conv5"}),
    (64, {"Conv2", "Conv3", "Conv4", "Conv5"}),
])
def test_default_schedule_ties_go_to_torch(batch, on_kernels):
    """Memory-bound layers price the same on both engines of one card; the
    tie keeps the first engine, torch, as the reference keeps xla."""
    plan = scheduler.schedule(lm.alexnet_full_spec(),
                              engines.DEFAULT_ENGINES, batch=batch)
    assert {a.spec.name for a in plan.assignments
            if a.engine == "hopper"} == on_kernels
    # both engines share the card: switching between them is free
    assert all(t.t_transfer == 0.0 for *_, t in plan.offload_overhead())


def test_kernel_only_plan_puts_every_layer_on_hopper():
    plan = scheduler.schedule(lm.alexnet_full_spec(), [engines.HOPPER_ENGINE])
    assert {a.engine for a in plan.assignments} == {"hopper"}


def test_measured_pricing_not_yet_ported():
    """The name is historical: measured pricing is ported now.  With an
    empty cache and no measuring on a miss, a measured schedule falls back
    to the analytic model for every candidate, as the reference's does, so
    it equals the analytic plan exactly; an unknown source still raises."""
    from repro_torch.profiling import MeasuredPricer, ProfileCache
    net = lm.alexnet_full_spec()
    pricer = MeasuredPricer(ProfileCache(device="cpu"), measure_on_miss=False,
                            autosave=False, device="cpu")
    measured = scheduler.schedule(net, engines.DEFAULT_ENGINES, batch=64,
                                  price="measured", pricer=pricer)
    analytic = scheduler.schedule(net, engines.DEFAULT_ENGINES, batch=64)
    assert measured.pricing == "measured" and (pricer.hits,
                                               pricer.misses) == (0, 0)
    assert measured.assignments == analytic.assignments
    with pytest.raises(ValueError, match="unknown pricing"):
        scheduler.schedule(lm.alexnet_full_spec(), engines.DEFAULT_ENGINES,
                           price="guess")
