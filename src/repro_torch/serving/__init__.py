"""Continuous-batching serving runtime on the dense or block-paged KV cache:
request lifecycle and arrivals, the slot/block pool with prefix sharing,
admission priced on the H100 device model, the open-loop driver with its
streaming channel, the colocated engine loop (its step replayed as a CUDA
graph on a card), phase placement and the disaggregated loop (a prefill and
a decode slot engine with an exact slot hand-off), and the typed entry
point ``api.serve(ServeOptions)`` with the static server.

Still to port from the JAX package: speculative decoding.
"""
from .api import ServeOptions, ServeReport, Server, serve
from .batcher import ContinuousBatcher, phase_network_spec, step_time_model
from .disagg import DisaggregatedEngineLoop, HandoffLedger
from .driver import OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink
from .engine_loop import EngineLoop, SlotEngine
from .kv_pool import KVPool
from .placement import (PhaseCost, PlacementDecision, handoff_payload_bytes,
                        phase_cost, place_phases, prefill_network_spec)
from .request import Request, RequestState, synthetic_workload

__all__ = [
    "ContinuousBatcher", "DisaggregatedEngineLoop", "EngineLoop",
    "HandoffLedger", "KVPool", "OpenLoopDriver", "PhaseCost",
    "PlacementDecision", "Request", "RequestState", "ServeMetrics",
    "ServeOptions", "ServeReport", "Server", "SlotEngine", "StreamDelta",
    "TokenSink", "handoff_payload_bytes", "phase_cost", "phase_network_spec",
    "place_phases", "prefill_network_spec", "serve", "step_time_model",
    "synthetic_workload",
]
