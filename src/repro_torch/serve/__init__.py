"""Continuous-batching serving engine on the ODB admission core."""

from repro_torch.serve.engine import ContinuousBatchingEngine, ServeConfig, ServeStats
from repro_torch.serve.requests import (
    EVICTED,
    FINISHED,
    QUEUED,
    RUNNING,
    SHED,
    WAITING,
    Request,
    RequestWindow,
    synth_request_trace,
)
from repro_torch.serve.slots import SlotManager

__all__ = [
    "ContinuousBatchingEngine",
    "EVICTED",
    "FINISHED",
    "QUEUED",
    "RUNNING",
    "Request",
    "RequestWindow",
    "ServeConfig",
    "ServeStats",
    "SHED",
    "SlotManager",
    "WAITING",
    "synth_request_trace",
]
