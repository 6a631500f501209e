"""The port's paper bench (benchmarks/bench_torch_paper.py) against the JAX
package's paper benchmarks, on the CPU.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

Its analytic rows (Table I, Fig. 6, Figs. 7-8 part 1, Table III's DE5 rows,
the scheduler's plans) must equal the reference modules' rows by name and
value.  The scheduler plans on the engine registry, whose two buildable
engines the reference prices on its TPU model and the port on its H100
model; so the reference module is run with the port's two engines in its
registry, carried across as reference engines on an equal device model.
Figs. 7-8 part 2 times kernels and runs only on the card (chip_smoke.py);
here the reference's part 2 is run without its timing, for its row names.
"""
import dataclasses

import pytest
import torch

from benchmarks import bench_fig6_tradeoff as jfig6
from benchmarks import bench_fig7_fig8_engines as jfig78
from benchmarks import bench_scheduler as jsched_bench
from benchmarks import bench_table1_flops as jtable1
from benchmarks import bench_table3_resources as jtable3
from benchmarks import bench_torch_paper as paper
from repro.core import device_models as jdm
from repro.core import engines as jeng
from repro_torch.core import engines as E

torch.set_num_threads(2)


def test_table1_rows_equal_the_reference():
    assert paper.table1_rows() == jtable1.run()


def test_fig6_rows_equal_the_reference():
    assert paper.fig6_rows() == jfig6.run()


def test_fig7_fig8_part1_equals_the_reference(monkeypatch):
    # the reference's part 2 without its timing (no kernel runs): its rows
    # keep their names, with the port's engine names in place of its own
    monkeypatch.setattr(jfig78, "_time", lambda *a, **k: 0.0)
    want = jfig78.run()
    assert paper.fig7_fig8_rows(device="cpu") == [
        r for r in want if r[0] == "fig7_8_model"]
    renamed = {r[1].replace("xla", "torch").replace("pallas", "hopper")
               for r in want if r[0] == "fig7_8_measured"}
    assert renamed == {f"{fc}_{d}_{e}_us" for fc in ("FC6", "FC7", "FC8")
                       for d, e in (("fwd", "torch"), ("fwd", "hopper"),
                                    ("bwd", "torch"))}


def test_fig7_fig8_part2_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        paper.fig7_fig8_rows(device="cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        paper.main(["--only", "table1"])


def test_table3_de5_rows_equal_the_reference():
    mine = [r for r in paper.table3_rows() if r[0] == "table3_fpga"]
    assert mine == [r for r in jtable3.run() if r[0] == "table3_fpga"]


def test_table3_smem_rows_cover_every_kernel_and_fit():
    rows = [r for r in paper.table3_rows() if r[0] == "table3_smem"]
    kernels = {r[1].split("_")[0] for r in rows}
    assert kernels == {"conv2d", "pool", "lrn", "matmul", "flash", "paged"}
    for _, name, n_bytes, _, status in rows:
        assert 0 < n_bytes <= 232_448 and status == "FITS", name


def _as_reference_engine(engine):
    """A reference engine with the port engine's name, kinds and efficiency
    on a reference device model equal to the port's H100 model."""
    device = jdm.DeviceModel(**{f.name: getattr(engine.device, f.name)
                                for f in dataclasses.fields(engine.device)})
    return jeng.ExecutionEngine(name=engine.name, device=device,
                                kinds=engine.kinds,
                                efficiency=engine.efficiency)


def test_scheduler_rows_equal_the_reference_on_the_same_engines(
        monkeypatch):
    registry = tuple(_as_reference_engine(e) for e in E.DEFAULT_ENGINES) \
        + jeng.ALL_ENGINES[len(jeng.DEFAULT_ENGINES):]
    assert [e.name for e in registry] == [e.name for e in E.ALL_ENGINES]
    monkeypatch.setattr(jeng, "ALL_ENGINES", registry)
    want, mine = jsched_bench.run(), paper.scheduler_rows()
    assert [r[:2] for r in mine] == [r[:2] for r in want]
    # every row but the scheduling latency (a host timing) is analytic
    assert mine[1:] == want[1:]
    assert mine[0][3] == want[0][3]
