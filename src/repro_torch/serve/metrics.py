"""Serving metrics: latency percentiles, queue depth, batch occupancy,
resilience counters, and plan-cache snapshots for the fused-plan server.

Everything here is plain-python and thread-safe: worker threads record
per-request latencies and per-batch occupancy into bounded reservoirs
(ring buffers — a long-lived server must not accumulate unbounded
history), and :meth:`ServerMetrics.snapshot` exports the whole state as
a JSON-able dict.  :meth:`ServerMetrics.report` is the ``explain()``-
style nested report ``chip_smoke.py``'s serving phases print.

Glossary (the keys ``snapshot()`` exports):

``requests``
    ``submitted`` / ``completed`` / ``failed`` (resolved with a typed
    execution error) / ``rejected`` (typed admission error at
    ``submit`` time — never enqueued) / ``deadline_exceeded`` /
    ``cancelled`` (still queued at ``close()``).
``latency_us``
    Submit-to-result wall latency percentiles (``p50``/``p95``/``p99``),
    mean, and the reservoir count they were computed over.
``batches``
    ``count`` (dispatches), ``batched_requests`` (requests that shared
    a dispatch with at least one other), ``padded_requests`` (requests
    zero-padded up to their shape class), ``occupancy_mean`` /
    ``occupancy_max`` (requests per dispatch), ``pad_fallbacks``
    (buckets that degraded to exact-shape batching because padding was
    proven unsafe for the plan's outputs), ``failed_dispatches``
    (tier-0 dispatches that raised — their requests then walk the
    degradation ladder, so a failed dispatch is *not* a failed
    request).
``queue``
    Current depth and the high-water mark.
``buckets``
    Per-bucket counters keyed by the structural plan digest: requests,
    batches, compiles and compile seconds.
``resilience``
    The self-healing ledger: ``rejected`` by reason (``backpressure`` /
    ``quarantined``), ``degraded`` requests per ladder tier (``exact``
    / ``per_op``), ``bisections``, ``nonfinite_detected``,
    ``retries_exhausted``, ``workers`` (``crashes`` / ``respawns`` /
    ``requeued_requests``), and ``breaker`` transition counts
    (``opens`` / ``probes`` / ``closes``).
``runtime_fallbacks``
    Bounded ledger of explicit run-time degradations — the run-time
    extension of the plan-time ``record_fallback`` discipline: one
    ``{site, tier, reason, count}`` row per distinct downgrade, so no
    degradation is silent.
``cache``
    :func:`repro_torch.core.plan_cache_stats` and
    :func:`repro_torch.core.whole_plan_cache_stats` snapshots (hit/miss/
    eviction/capacity/build-time), i.e. plan-cache lifecycle under
    churn.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import asdict
from typing import Iterable, Optional

import numpy as np

#: bounded history kept per reservoir (latencies, occupancies)
RESERVOIR_SIZE = 8192
#: per-bucket counter records kept (LRU past this; drops are counted)
BUCKET_STATS_CAPACITY = 1024
#: distinct runtime-fallback rows kept (LRU past this)
FALLBACK_LEDGER_CAPACITY = 256


def percentiles(values: Iterable[float],
                qs: tuple[float, ...] = (50.0, 95.0, 99.0)) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``values`` (empty
    input yields zeros) — shared by the metrics layer and the load
    drivers so both report identical definitions."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return {f"p{q:g}": 0.0 for q in qs}
    return {f"p{q:g}": float(np.percentile(vals, q)) for q in qs}


class Reservoir:
    """Bounded, thread-compatible sample window (ring buffer)."""

    def __init__(self, size: int = RESERVOIR_SIZE) -> None:
        self._ring: "deque[float]" = deque(maxlen=size)
        self.count = 0            # total ever recorded (not just retained)

    def add(self, value: float) -> None:
        self._ring.append(float(value))
        self.count += 1

    def values(self) -> list[float]:
        return list(self._ring)

    def summary(self, qs: tuple[float, ...] = (50.0, 95.0, 99.0)) -> dict:
        vals = self.values()
        out = percentiles(vals, qs)
        out["mean"] = float(np.mean(vals)) if vals else 0.0
        out["max"] = float(np.max(vals)) if vals else 0.0
        out["count"] = self.count
        return out


class ServerMetrics:
    """Thread-safe counters + reservoirs for one :class:`FusionServer`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.batches = 0
        self.batched_requests = 0
        self.padded_requests = 0
        self.pad_fallbacks = 0
        self.failed_dispatches = 0
        self.compiles = 0
        self.compile_time_s = 0.0
        self.queue_depth = 0
        self.peak_queue_depth = 0
        self.latency_us = Reservoir()
        self.occupancy = Reservoir()
        self._buckets: "OrderedDict[str, dict]" = OrderedDict()
        self.dropped_buckets = 0
        # resilience ledger
        self.deadline_exceeded = 0
        self.cancelled = 0
        self.rejected_by_reason: dict[str, int] = {}
        self.degraded: dict[str, int] = {}
        self.bisections = 0
        self.nonfinite_detected = 0
        self.retries_exhausted = 0
        self.worker_crashes = 0
        self.worker_respawns = 0
        self.requeued_requests = 0
        self.breaker_events: dict[str, int] = {}
        self._fallbacks: "OrderedDict[tuple, dict]" = OrderedDict()
        self.dropped_fallbacks = 0

    # -- recording (called by the server) ------------------------------------
    def on_submit(self, depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth = depth
            self.peak_queue_depth = max(self.peak_queue_depth, depth)

    def on_reject(self, reason: str = "admission") -> None:
        with self._lock:
            self.rejected += 1
            self.rejected_by_reason[reason] = \
                self.rejected_by_reason.get(reason, 0) + 1

    def on_compile(self, bucket: str, seconds: float,
                   pad_fallback: bool = False) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_time_s += seconds
            if pad_fallback:
                self.pad_fallbacks += 1
            rec = self._bucket(bucket)
            rec["compiles"] += 1
            rec["compile_time_s"] += seconds

    def on_dispatch(self, bucket: str, size: int, padded: int,
                    depth: int, failed: bool = False) -> None:
        """One tier-0 dispatch (batched or single).  ``failed`` counts
        the *dispatch*; its requests are accounted when their futures
        resolve (``on_result``)."""
        with self._lock:
            self.batches += 1
            self.occupancy.add(size)
            self.queue_depth = depth
            if size > 1:
                self.batched_requests += size
            self.padded_requests += padded
            if failed:
                self.failed_dispatches += 1
            rec = self._bucket(bucket)
            rec["requests"] += size
            rec["batches"] += 1

    def on_result(self, bucket: str, latency_us: Optional[float],
                  failed: bool = False) -> None:
        """One request future resolved (result or typed error)."""
        with self._lock:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
                if latency_us is not None:
                    self.latency_us.add(latency_us)

    def on_deadline(self, bucket: str = "") -> None:
        with self._lock:
            self.deadline_exceeded += 1

    def on_cancel(self) -> None:
        with self._lock:
            self.cancelled += 1

    def on_bisect(self) -> None:
        with self._lock:
            self.bisections += 1

    def on_nonfinite(self, bucket: str = "") -> None:
        with self._lock:
            self.nonfinite_detected += 1

    def on_degrade(self, tier: str, bucket: str = "") -> None:
        with self._lock:
            self.degraded[tier] = self.degraded.get(tier, 0) + 1

    def on_retries_exhausted(self, bucket: str = "") -> None:
        with self._lock:
            self.retries_exhausted += 1

    def on_worker_crash(self, kind: str = "") -> None:
        with self._lock:
            self.worker_crashes += 1

    def on_worker_respawn(self) -> None:
        with self._lock:
            self.worker_respawns += 1

    def on_requeue(self, n: int) -> None:
        with self._lock:
            self.requeued_requests += n

    def on_breaker(self, event: str) -> None:
        with self._lock:
            self.breaker_events[event] = \
                self.breaker_events.get(event, 0) + 1

    def on_runtime_fallback(self, site: str, reason: str,
                            tier: str = "") -> None:
        """Record one explicit run-time degradation — the serving-side
        mirror of ``CompiledPlan.record_fallback`` (EXE005: no silent
        fallbacks, at plan time or run time)."""
        with self._lock:
            key = (site, tier, reason)
            rec = self._fallbacks.get(key)
            if rec is None:
                rec = {"site": site, "tier": tier, "reason": reason,
                       "count": 0}
                self._fallbacks[key] = rec
                while len(self._fallbacks) > FALLBACK_LEDGER_CAPACITY:
                    self._fallbacks.popitem(last=False)
                    self.dropped_fallbacks += 1
            else:
                self._fallbacks.move_to_end(key)
            rec["count"] += 1

    def _bucket(self, key: str) -> dict:
        rec = self._buckets.get(key)
        if rec is None:
            rec = {"bucket": key, "requests": 0, "batches": 0,
                   "compiles": 0, "compile_time_s": 0.0}
            self._buckets[key] = rec
            while len(self._buckets) > BUCKET_STATS_CAPACITY:
                self._buckets.popitem(last=False)
                self.dropped_buckets += 1
        else:
            self._buckets.move_to_end(key)
        return rec

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able state dump (see the module docstring's glossary)."""
        from repro_torch.core import plan_cache_stats, whole_plan_cache_stats
        with self._lock:
            occ = self.occupancy.summary(qs=(50.0,))
            snap = {
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "failed": self.failed,
                    "rejected": self.rejected,
                    "deadline_exceeded": self.deadline_exceeded,
                    "cancelled": self.cancelled,
                },
                "latency_us": self.latency_us.summary(),
                "batches": {
                    "count": self.batches,
                    "batched_requests": self.batched_requests,
                    "padded_requests": self.padded_requests,
                    "occupancy_mean": occ["mean"],
                    "occupancy_max": occ["max"],
                    "pad_fallbacks": self.pad_fallbacks,
                    "failed_dispatches": self.failed_dispatches,
                },
                "queue": {
                    "depth": self.queue_depth,
                    "peak_depth": self.peak_queue_depth,
                },
                "compiles": {
                    "count": self.compiles,
                    "time_s": round(self.compile_time_s, 6),
                },
                "resilience": {
                    "rejected": dict(self.rejected_by_reason),
                    "degraded": dict(self.degraded),
                    "bisections": self.bisections,
                    "nonfinite_detected": self.nonfinite_detected,
                    "retries_exhausted": self.retries_exhausted,
                    "workers": {
                        "crashes": self.worker_crashes,
                        "respawns": self.worker_respawns,
                        "requeued_requests": self.requeued_requests,
                    },
                    "breaker": dict(self.breaker_events),
                },
                "runtime_fallbacks": [dict(r)
                                      for r in self._fallbacks.values()],
                "dropped_fallbacks": self.dropped_fallbacks,
                "buckets": [dict(r) for r in self._buckets.values()],
                "dropped_buckets": self.dropped_buckets,
            }
        snap["cache"] = {
            "plan": asdict(plan_cache_stats()),
            "whole_plan": asdict(whole_plan_cache_stats()),
        }
        return snap

    def report(self, server: Optional[object] = None,
               top_keys: int = 8) -> dict:
        """``explain()``-style report: the snapshot plus the server's
        configuration, quarantined plans, and the hottest whole-plan
        cache keys."""
        from repro_torch.core.codegen import WHOLE_PLAN_CACHE
        doc = {"serving": self.snapshot()}
        if server is not None:
            doc["server"] = {
                "workers": getattr(server, "workers", None),
                "max_batch": getattr(server, "max_batch", None),
                "pad_to": getattr(server, "pad_to", None),
                "max_queue": getattr(server, "max_queue", None),
                "retry_budget": getattr(server, "retry_budget", None),
                "entries": len(getattr(server, "_entries", ()) or ()),
            }
            breaker = getattr(server, "breaker", None)
            if breaker is not None:
                keys = breaker.snapshot()
                doc["server"]["breaker"] = {
                    "threshold": breaker.threshold,
                    "cooldown_s": breaker.cooldown_s,
                    "keys": keys,
                    "quarantined": [r for r in keys
                                    if r["state"] != "closed"],
                }
        doc["serving"]["cache"]["whole_plan_keys"] = \
            WHOLE_PLAN_CACHE.key_stats(top=top_keys)
        return doc
