"""Continuous-batching serving runtime on the dense or block-paged KV cache:
request lifecycle and arrivals, the slot/block pool with prefix sharing,
admission priced on the H100 device model, the open-loop driver with its
streaming channel, the colocated engine loop (its step replayed as a CUDA
graph on a card), and the typed entry point ``api.serve(ServeOptions)``
with the static server.

Still to port from the JAX package: phase disaggregation and placement,
speculative decoding.
"""
from .api import ServeOptions, ServeReport, Server, serve
from .batcher import ContinuousBatcher, phase_network_spec, step_time_model
from .driver import OpenLoopDriver, ServeMetrics, StreamDelta, TokenSink
from .engine_loop import EngineLoop, SlotEngine
from .kv_pool import KVPool
from .request import Request, RequestState, synthetic_workload

__all__ = [
    "ContinuousBatcher", "EngineLoop", "KVPool", "OpenLoopDriver", "Request",
    "RequestState", "ServeMetrics", "ServeOptions", "ServeReport", "Server",
    "SlotEngine", "StreamDelta", "TokenSink", "phase_network_spec", "serve",
    "step_time_model", "synthetic_workload",
]
