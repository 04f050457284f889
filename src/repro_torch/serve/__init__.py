"""Serving on the card: :class:`FusionServer` (async continuous batching
over compiled plans, one request-axis kernel launch per fused operator and
batch), its metrics, the LM :class:`Engine` (continuous batching of
prefill and KV-cache decode over the port's LM, on one device or sharded
over the ranks of a :class:`~repro_torch.dist.Mesh` by the layout rules or
the layout planner), and the shared error taxonomy."""

from .engine import Engine, Request
from .errors import (AdmissionError, DeadlineExceededError,
                     FusionServeError, NonFiniteOutputError,
                     PlanCompileError, PlanQuarantinedError,
                     QueueFullError, RequestFailedError, ServerClosedError)
from .fusion import (CircuitBreaker, FusionServer, PadReport, pad_safety)
from .metrics import Reservoir, ServerMetrics, percentiles

__all__ = [
    "Engine", "Request",
    "FusionServer", "CircuitBreaker",
    "FusionServeError", "ServerClosedError", "AdmissionError",
    "QueueFullError", "DeadlineExceededError", "PlanQuarantinedError",
    "PlanCompileError", "RequestFailedError", "NonFiniteOutputError",
    "PadReport", "pad_safety",
    "ServerMetrics", "Reservoir", "percentiles",
]
