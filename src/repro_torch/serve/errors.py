"""Shared serving error taxonomy.

The fused-plan server (:class:`~repro_torch.serve.fusion.FusionServer`)
rejects and fails requests through this one hierarchy (the reference's
taxonomy, shared there with its LM ``Engine``), so clients catch
``FusionServeError`` and switch on the subtype.  Admission-time
errors (closed server, bad operands, backpressure, quarantine) are
raised at ``submit`` and the request is never enqueued; runtime errors
(deadline, exhausted retries, non-finite outputs) resolve the request's
future exceptionally — a submitted request always ends in exactly one
of: a result, or one typed error."""

from __future__ import annotations


class FusionServeError(RuntimeError):
    """Root of the serving error taxonomy."""


class ServerClosedError(FusionServeError):
    """The server has been closed (or has no workers to drain the
    queue).  At ``submit``: the request was not enqueued.  On a future:
    the request was still queued when ``close()`` drained the queue."""


class AdmissionError(FusionServeError, ValueError):
    """The request can never be served as posed (operands not matching
    the region signature, an operand that is not an array).  Subclasses
    ``ValueError``, as in the reference."""


class QueueFullError(FusionServeError):
    """Bounded-queue backpressure: the admission queue is at
    ``max_queue`` and the request was rejected, not enqueued.  Clients
    should shed load or retry with backoff."""


class DeadlineExceededError(FusionServeError):
    """The request's deadline passed before a worker could finish it
    (checked at dequeue and at every degradation-ladder step; an
    execution already in flight runs to completion)."""


class PlanQuarantinedError(FusionServeError):
    """The request's plan digest is quarantined by the circuit breaker
    after repeated failures; rejected at submit until the breaker's
    cooldown elapses and a probe request closes it again."""


class PlanCompileError(FusionServeError):
    """Trace/plan/compile failed for the request's region at its shape
    class — no executable exists on any ladder tier.  Repeated compile
    failures trip the build circuit breaker (→
    :class:`PlanQuarantinedError` on subsequent submits)."""


class RequestFailedError(FusionServeError):
    """Terminal runtime failure: every degradation tier the retry
    budget allowed was exhausted without producing a result.  The
    original cause is chained as ``__cause__``."""


class NonFiniteOutputError(FusionServeError):
    """The request's outputs contained NaN/Inf (servers constructed
    with ``check_finite=True`` verify every tier's outputs; a
    non-finite result degrades down the ladder and, if every tier
    reproduces it, fails with this)."""
