"""Fused-plan serving on the card: :class:`FusionServer` (async continuous
batching over compiled plans, one request-axis kernel launch per fused
operator and batch), its metrics, and the shared error taxonomy.  The
reference's LM ``Engine`` belongs to the LM stack (ROADMAP.md queue A
item 7) and is not ported yet."""

from .errors import (AdmissionError, DeadlineExceededError,
                     FusionServeError, NonFiniteOutputError,
                     PlanCompileError, PlanQuarantinedError,
                     QueueFullError, RequestFailedError, ServerClosedError)
from .fusion import (CircuitBreaker, FusionServer, PadReport, pad_safety)
from .metrics import Reservoir, ServerMetrics, percentiles

__all__ = [
    "FusionServer", "CircuitBreaker",
    "FusionServeError", "ServerClosedError", "AdmissionError",
    "QueueFullError", "DeadlineExceededError", "PlanQuarantinedError",
    "PlanCompileError", "RequestFailedError", "NonFiniteOutputError",
    "PadReport", "pad_safety",
    "ServerMetrics", "Reservoir", "percentiles",
]
