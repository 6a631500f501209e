"""Calibrator: fit device-model parameters from measurements.

The analytic H100 model prices a layer from first principles (roofline
with an engine ``efficiency`` guess).  Calibration replaces the guess with the
achieved rate the microbenchmarks actually observed, exactly how CNNLab
built its K40/DE5 models from measured boards (§IV.B):

    achieved[kind] = sum(FLOPs) / sum(median time)      over that kind

— a FLOP-weighted fit, so big layers (which dominate plan time) dominate
the per-kind rate.  The result is a :class:`CalibratedDeviceModel`, an
``analytic=False`` :class:`~repro.core.device_models.DeviceModel` that
drops straight into ``core/cost_model.layer_cost`` and everything above it
(scheduler, batcher, trade-off analysis).  Kinds never measured fall back
to ``base_efficiency x peak_flops`` — the engine's nominal analytic guess —
instead of raw peak, so an under-profiled cache cannot make unmeasured
layers look infinitely fast.

:func:`calibration_report` quantifies the win: per-layer analytic vs
calibrated predicted time against the measurement, aggregated as MAPE
(mean absolute percentage error).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from ..core import device_models as dm
from ..core.cost_model import layer_cost
from ..core.engines import ExecutionEngine
from ..core.layer_model import LayerSpec
from .bench import Measurement


@dataclasses.dataclass(frozen=True)
class CalibratedDeviceModel(dm.DeviceModel):
    """A DeviceModel whose per-kind throughput came from measurements.

    Measured kinds are priced empirically (the measurement folds in memory
    behaviour).  Unmeasured kinds fall back to the *base* model's pricing
    discipline: if the base was analytic, the full roofline — including
    the memory and collective terms — scaled by the engine's nominal
    ``base_efficiency``, so an under-profiled cache cannot under-price
    memory-bound layers (e.g. serving decode) to compute-only optimism.
    """

    base_efficiency: float = 1.0         # fallback for unmeasured kinds
    base_analytic: bool = False          # was the base model roofline-priced?
    source_engine: str = ""
    n_measurements: int = 0

    def achieved_flops(self, kind: str, direction: str = "fwd") -> float:
        if direction == "bwd" and kind in self.throughput_bwd:
            return self.throughput_bwd[kind]
        if kind in self.throughput:
            return self.throughput[kind]
        return self.base_efficiency * self.peak_flops

    def analytic_for(self, kind: str) -> bool:
        return self.base_analytic and kind not in self.throughput

    def roofline_efficiency(self, kind: str) -> float:
        return self.base_efficiency


def fit_kind_rates(measurements: Iterable[Measurement]) -> Dict[str, float]:
    """FLOP-weighted achieved rate per layer kind."""
    flops: Dict[str, float] = {}
    seconds: Dict[str, float] = {}
    for m in measurements:
        flops[m.kind] = flops.get(m.kind, 0.0) + m.flops
        seconds[m.kind] = seconds.get(m.kind, 0.0) + m.t_median
    return {k: flops[k] / seconds[k]
            for k in flops if seconds[k] > 0 and flops[k] > 0}


def calibrate_engine(
    engine: ExecutionEngine,
    measurements: Sequence[Measurement],
    *,
    register: bool = False,
) -> CalibratedDeviceModel:
    """Fit a calibrated device model for ``engine`` from its measurements.

    When ``register`` the model joins ``core.device_models.REGISTRY`` under
    ``"<device>-measured-<engine>"`` so name-keyed consumers (the serving
    batcher's ``device_name``) can price on it.
    """
    mine = [m for m in measurements if m.engine == engine.name]
    if not mine:
        raise ValueError(f"no measurements for engine {engine.name}")
    base = engine.device
    model = CalibratedDeviceModel(
        name=f"{base.name}-measured-{engine.name}",
        peak_flops=base.peak_flops,
        mem_bw=base.mem_bw,
        link_bw=base.link_bw,
        vmem_bytes=base.vmem_bytes,
        analytic=False,
        throughput=fit_kind_rates(mine),
        power=dict(base.power),
        power_active=base.power_active,
        power_idle=base.power_idle,
        frequency_hz=base.frequency_hz,
        base_efficiency=engine.efficiency if base.analytic else 1.0,
        base_analytic=base.analytic,
        source_engine=engine.name,
        n_measurements=len(mine),
    )
    if register:
        dm.register(model, overwrite=True)
    return model


# ---------------------------------------------------------------------------
# Prediction-error reporting (before/after calibration)
# ---------------------------------------------------------------------------
def analytic_predicted_time(spec: LayerSpec, engine: ExecutionEngine, *,
                            batch: int = 1, dtype_bytes: int = 4) -> float:
    """What the uncalibrated scheduler believes this layer costs."""
    eff = engine.efficiency if engine.device.analytic else 1.0
    return layer_cost(spec, engine.device, batch=batch,
                      dtype_bytes=dtype_bytes, mxu_efficiency=eff).t_total


@dataclasses.dataclass(frozen=True)
class LayerPrediction:
    layer: str
    kind: str
    measured_s: float
    analytic_s: float
    calibrated_s: float

    @property
    def analytic_err(self) -> float:
        return abs(self.analytic_s - self.measured_s) / self.measured_s

    @property
    def calibrated_err(self) -> float:
        return abs(self.calibrated_s - self.measured_s) / self.measured_s


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    engine: str
    model: CalibratedDeviceModel
    predictions: Tuple[LayerPrediction, ...]

    def _mape(self, attr: str) -> float:
        errs = [getattr(p, attr) for p in self.predictions]
        return sum(errs) / len(errs) if errs else float("nan")

    @property
    def analytic_mape(self) -> float:
        return self._mape("analytic_err")

    @property
    def calibrated_mape(self) -> float:
        return self._mape("calibrated_err")

    def per_kind(self) -> Dict[str, Dict[str, float]]:
        kinds: Dict[str, List[LayerPrediction]] = {}
        for p in self.predictions:
            kinds.setdefault(p.kind, []).append(p)
        return {
            k: {
                "n": len(ps),
                "analytic_mape": sum(p.analytic_err for p in ps) / len(ps),
                "calibrated_mape": sum(p.calibrated_err for p in ps) / len(ps),
            }
            for k, ps in kinds.items()
        }

    def summary(self) -> str:
        rows = [f"{'layer':<8} {'kind':<6} {'measured':>11} {'analytic':>11} "
                f"{'calibrated':>11} {'err_a':>8} {'err_c':>8}"]
        for p in self.predictions:
            rows.append(
                f"{p.layer:<8} {p.kind:<6} {p.measured_s*1e3:>9.3f}ms "
                f"{p.analytic_s*1e3:>9.3f}ms {p.calibrated_s*1e3:>9.3f}ms "
                f"{p.analytic_err:>8.2%} {p.calibrated_err:>8.2%}")
        rows.append(f"[{self.engine}] MAPE analytic {self.analytic_mape:.2%} "
                    f"-> calibrated {self.calibrated_mape:.2%} "
                    f"({len(self.predictions)} layers)")
        return "\n".join(rows)


def calibration_report(
    engine: ExecutionEngine,
    specs: Sequence[LayerSpec],
    measurements: Sequence[Measurement],
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    register: bool = False,
) -> CalibrationReport:
    """Fit + score: calibrate ``engine`` and report prediction error
    before/after on every measured layer in ``specs``."""
    model = calibrate_engine(engine, measurements, register=register)
    by_layer = {(m.layer, m.engine): m for m in measurements}
    preds = []
    for spec in specs:
        m = by_layer.get((spec.name, engine.name))
        if m is None or m.t_median <= 0:
            continue
        cal = layer_cost(spec, model, batch=batch,
                         dtype_bytes=dtype_bytes).t_total
        preds.append(LayerPrediction(
            layer=spec.name, kind=spec.kind, measured_s=m.t_median,
            analytic_s=analytic_predicted_time(
                spec, engine, batch=batch, dtype_bytes=dtype_bytes),
            calibrated_s=cal))
    return CalibrationReport(engine=engine.name, model=model,
                             predictions=tuple(preds))
