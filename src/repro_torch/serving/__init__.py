"""Continuous-batching serving runtime on the block-paged KV cache: request
lifecycle and arrivals, the slot/block pool with prefix sharing, admission
priced on the H100 device model, the open-loop driver with its streaming
channel, and the colocated engine loop.

Still to port from the JAX package: the typed ``api.serve`` entry point,
phase disaggregation and placement, speculative decoding.
"""
from .batcher import ContinuousBatcher, phase_network_spec, step_time_model
from .driver import OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink
from .engine_loop import EngineLoop, SlotEngine
from .kv_pool import KVPool
from .request import Request, RequestState, synthetic_workload

__all__ = [
    "ContinuousBatcher", "EngineLoop", "KVPool", "OpenLoopDriver", "Request",
    "RequestState", "ServeMetrics", "SlotEngine", "StreamDelta", "TokenSink",
    "phase_network_spec", "step_time_model", "synthetic_workload",
]
