"""Empirical profiling & cost-model calibration runtime.

CNNLab's middleware decides offload targets from *measured* device
behaviour; this package is that measurement layer for the port:

* ``bench``     — microbenchmark harness (warmup, CUDA events around each
  call, median + IQR over repeats) for any buildable engine x LayerSpec;
* ``cache``     — persistent JSON profile cache keyed by (spec
  fingerprint, engine, torch version, device name, capability) with
  load/merge/invalidate;
* ``calibrate`` — fits per-kind achieved rates into a
  ``CalibratedDeviceModel`` that drops into ``core/cost_model.py``, and
  reports prediction error before/after;
* ``pricer``    — ``MeasuredPricer``, the measure-on-miss pricing source
  behind ``core.scheduler.schedule(..., price="measured")``;
* ``transfer``  — the measured inter-device copy rate that prices the
  disaggregated hand-off (``measure_link_bandwidth``, ``record_link_bw``,
  ``cached_link_bw``);
* ``acceptance`` — a serve run's measured speculative-decoding acceptance
  rate per (draft, target) pair (``record_acceptance``,
  ``cached_acceptance``), which prices the next run's speculation.

CLI: ``python -m repro_torch.launch.profile`` (measure + calibrate +
compare plans); benchmark: ``python -m benchmarks.bench_torch_profiling``.
"""
from .acceptance import (ACCEPTANCE_ENGINE, ACCEPTANCE_SOURCE,
                         AcceptanceSpec, acceptance_measurement,
                         cached_acceptance, record_acceptance)
from .bench import Measurement, make_input, profile_network, time_layer
from .cache import (DEFAULT_CACHE_PATH, ProfileCache, entry_key, environment,
                    fingerprint, validate_dict)
from .calibrate import (CalibratedDeviceModel, CalibrationReport,
                        LayerPrediction, analytic_predicted_time,
                        calibrate_engine, calibration_report, fit_kind_rates)
from .pricer import MeasuredPricer
from .transfer import (LINK_ENGINE, LINK_SOURCE, LinkSpec, cached_link_bw,
                       measure_link_bandwidth, record_link_bw)

__all__ = [
    "ACCEPTANCE_ENGINE", "ACCEPTANCE_SOURCE", "AcceptanceSpec",
    "CalibratedDeviceModel", "CalibrationReport", "DEFAULT_CACHE_PATH",
    "LINK_ENGINE", "LINK_SOURCE", "LayerPrediction", "LinkSpec",
    "Measurement", "MeasuredPricer", "ProfileCache",
    "acceptance_measurement", "analytic_predicted_time",
    "cached_acceptance", "cached_link_bw", "calibrate_engine",
    "calibration_report", "entry_key", "environment", "fingerprint",
    "fit_kind_rates", "make_input", "measure_link_bandwidth",
    "profile_network", "record_acceptance", "record_link_bw",
    "time_layer", "validate_dict",
]
