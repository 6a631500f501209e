"""Continuous-batching serving runtime on the dense or block-paged KV cache:
request lifecycle and arrivals, the slot/block pool with prefix sharing,
admission priced on the H100 device model, the open-loop driver with its
streaming channel, the colocated engine loop (its step replayed as a CUDA
graph on a card), phase placement and the disaggregated loop (a prefill and
a decode slot engine with an exact slot hand-off), draft-model speculative
decoding on either loop's decode engine, and the typed entry point
``api.serve(ServeOptions)`` with the static server.
"""
from .api import ServeOptions, ServeReport, Server, serve
from .batcher import ContinuousBatcher, phase_network_spec, step_time_model
from .disagg import DisaggregatedEngineLoop, HandoffLedger
from .driver import OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink
from .engine_loop import EngineLoop, SlotEngine
from .kv_pool import KVPool
from .placement import (PhaseCost, PlacementDecision, SpeculationDecision,
                        choose_speculation, handoff_payload_bytes,
                        phase_cost, place_phases, prefill_network_spec)
from .request import Request, RequestState, synthetic_workload
from .speculative import (SpecPlan, SpeculativeDecoder,
                          SpeculativeEngineLoop, validate_speculation)

__all__ = [
    "ContinuousBatcher", "DisaggregatedEngineLoop", "EngineLoop",
    "HandoffLedger", "KVPool", "OpenLoopDriver", "PhaseCost",
    "PlacementDecision", "Request", "RequestState", "ServeMetrics",
    "ServeOptions", "ServeReport", "Server", "SlotEngine", "SpecPlan",
    "SpeculationDecision", "SpeculativeDecoder", "SpeculativeEngineLoop",
    "StreamDelta",
    "TokenSink", "choose_speculation", "handoff_payload_bytes", "phase_cost",
    "phase_network_spec", "place_phases", "prefill_network_spec", "serve",
    "step_time_model", "synthetic_workload", "validate_speculation",
]
