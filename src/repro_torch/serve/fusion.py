"""Multi-tenant fused-plan serving: async continuous batching over
compiled whole plans, on the card.

The optimizer pays off only when compiled fusion plans are *reused* —
optimization and codegen cost amortize across invocations (the paper's
Fig. 11 argument).  :class:`FusionServer` is the traffic-facing form of
that claim: many concurrent clients submit fused-region invocations
(``submit(region, args) -> Future``), worker threads drain a shared
queue, and requests whose plans are structurally equal are executed as
*one* batched dispatch of the shared staged plan function.

Request path::

    submit(region, args)
      └─ canonicalize operands, carried to the server's device once
         → shape class (rows padded up to pad_to)
         └─ route: (region, class) → _PlanEntry  [trace→plan→compile,
            memoized; structurally-equal plans share one staged fn via
            the whole-plan cache]
            └─ enqueue ticket, bucketed by structural plan digest
    worker: pop head ticket, drain same-bucket tickets (≤ max_batch)
      └─ stack each operand into one device buffer (zero fill of the
         padded rows, batch padding repeats request 0), ONE call of the
         batched plan function: each fused operator one launch of its
         request-axis CUDA kernel for the whole batch
         └─ wait for the batch's kernels (an event), slice each
            request's outputs back to its true shape (device views),
            resolve futures, record latency/occupancy metrics

**Shape bucketing & padding.**  Requests rarely share exact shapes, so
the leading ("row") dimension is padded up to the next multiple of
``pad_to`` and requests sharing the padded class batch together.
Zero-padding is only sound for some plans: a padded row flows through
``relu(1 - y*(X@w))`` as a garbage-but-confined row (sliced away on
return), but through ``(...).sum()`` it *pollutes the scalar*.  The
server runs the reference's static **pad-safety analysis** over the
traced HOP DAG (:func:`pad_safety`, a copy) — propagating "padded rows
are zero / finite garbage / possibly non-finite" through every operator
and rejecting any contraction over the padded dimension whose operand is
not provably zero.  Plans that fail the analysis degrade to
**exact-shape buckets** (only identical shapes batch — still one
dispatch per batch), recorded as ``pad_fallbacks`` in the metrics.
Requests are computed independently, so the batched result equals
per-request execution (tested to 1e-5).

**Marshalling on the card.**  Operands are carried to the server's
device at ``submit``, in the client's thread; a batch is stacked into one
preallocated device buffer per operand, each request's slice 16-byte
aligned (:func:`~repro_torch.kernels.build.batch_empty`), so no request
crosses PCIe at dispatch.  A future resolves only after the batch's
kernels have finished (an event per batch), so latencies measure the
work and ``check_finite`` reads real values; results are tensors on the
server's device (views into the batch's outputs).  Workers share the
device's current stream; the Cell kernel's scratch is kept per (device,
stream) under a lock.

**Plan-cache lifecycle.**  Entries are memoized per (region, shape
class, context); underneath, the bounded LRU
:class:`~repro_torch.core.codegen.WholePlanCache` shares one staged
function across structurally-equal plans and its per-key hit/miss/
eviction/build-time counters survive entry churn.  ``warm(regions)``
compiles (and optionally executes) plans ahead of traffic.

**Fault tolerance.**  The server assumes builds, dispatches, and worker
threads *fail*: a failed batched dispatch bisects so one poison request
fails only its own future, then re-executes down a **degradation
ladder** — the batched plan function (request-axis kernels) → the
staged plan function per request → per-operator dispatch
(``staged=False``), all three under the same ``kernels`` policy — with a
per-request retry budget and optional deadline; repeatedly-failing plan
digests are quarantined by a **circuit breaker** (closed → open →
half-open probe); ``max_queue`` bounds the admission queue with typed
:class:`~repro_torch.serve.errors.QueueFullError` backpressure; a crashed
worker thread requeues its in-flight batch and respawns.  Every
degradation is explicit and counted in the metrics' runtime-fallback
ledger.  The seeded chaos harness (:mod:`repro_torch.faults`) exercises
all of it deterministically; with no schedule installed each fault point
is a single global read.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core import ir
from repro_torch.core.api import (Compiled, Planned, _canon_shape,
                                  _canon_value)
from repro_torch.core.codegen import (PLAN_CACHE, WHOLE_PLAN_CACHE,
                                      WholePlanCache)
from repro_torch.core.context import FusionContext, current_context
from repro_torch.interop import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.blocksparse import BCSR, DictCompressed
from .errors import (AdmissionError, DeadlineExceededError,
                     FusionServeError, NonFiniteOutputError,
                     PlanCompileError, PlanQuarantinedError,
                     QueueFullError, RequestFailedError, ServerClosedError)
from .metrics import ServerMetrics

faults.register_site(
    "serve.batch_dispatch",
    "batched (request-axis kernels) or exact/per-op degraded dispatch of "
    "one serving batch in a worker thread — the runtime execution site",
    kinds=("error", "nonfinite", "latency"),
    handler="degradation ladder: bisection isolates poison requests, "
            "failed work re-executes batched → exact-shape → per-op "
            "under the retry budget; repeated failures open the "
            "per-digest circuit breaker")

faults.register_site(
    "serve.worker",
    "worker loop body, after a batch is popped and before it executes",
    kinds=("crash", "latency"),
    handler="crash containment: in-flight tickets requeue at the front, "
            "a replacement thread spawns (worker_respawns metric), the "
            "pool never shrinks silently")


# --------------------------------------------------------------------------
# static pad-safety analysis
# --------------------------------------------------------------------------

_ZERO, _FIN, _NAN = 0, 1, 2          # padded-slice value severity
#: unary ops with f(0) finite but nonzero (padded zeros stop being zero)
_FIN_AT_ZERO = frozenset({"exp", "sigmoid", "softplus"})
#: unary ops that can turn finite garbage non-finite (domain edges)
_NAN_RISK = frozenset({"log", "recip", "sqrt", "log1p"})


@dataclass(frozen=True)
class PadReport:
    """Outcome of the pad-safety analysis for one traced region.

    ``safe`` — zero-padding the marked inputs' leading dimension and
    slicing every output back is exact; ``out_axes`` — per graph output,
    the axis carrying the padded dimension (``None``: the output never
    sees it and is exact as-is); ``reason`` — first violated rule when
    unsafe (drives the ``pad_fallbacks`` metric)."""
    safe: bool
    out_axes: tuple = ()
    reason: str = ""


def pad_safety(graph: ir.Graph, padded_inputs: frozenset) -> PadReport:
    """Decide whether zero-padding ``padded_inputs`` along axis 0 is
    exact for every output of ``graph`` (after slicing).

    Per node we track whether it carries the padded dimension (axis 0 or
    1 — transposes flip it) and what its padded slice provably holds:
    exactly **zero** (padding survives zero-preserving cell ops and
    anchors exact ``sum``/``matmul`` contractions), **finite garbage**
    (confined to the padded rows — safe until contracted), or
    **possibly non-finite** (``log(0)``, ``x/0`` … — also confined, but
    poisons any contraction, since ``0 · nan = nan``).  A contraction
    over the padded dimension (matmul inner dim, ``colsums``, full
    aggregates) is exact iff one side's padded slice is zero and the
    other is finite; ``mean``/``min``/``max`` over the padded dimension
    are never exact.  Anything the table doesn't cover fails closed."""
    state: dict[int, Optional[tuple[int, int]]] = {}

    def unsafe(node: ir.Node, why: str) -> PadReport:
        return PadReport(False, (),
                         f"%{node.nid} {node.op}: {why}")

    def fin(s) -> bool:          # finite padded slice (or real data)
        return s is None or s[1] <= _FIN

    for node in graph.nodes:
        op, ins = node.op, node.inputs
        sts = [state.get(i.nid) for i in ins]
        if op == "input":
            state[node.nid] = (0, _ZERO) if node.name in padded_inputs \
                else None
            continue
        if op == "lit":
            state[node.nid] = None
            continue
        if all(s is None for s in sts):
            state[node.nid] = None
            continue
        if op == "t":
            ax, sev = sts[0]
            state[node.nid] = (1 - ax, sev)
        elif op == "idx":
            if sts[0][0] == 1:
                return unsafe(node, "column slice of the padded axis")
            state[node.nid] = sts[0]
        elif op == "matmul":
            sa, sb = sts[0], sts[1]
            ta, tb = node.ta, node.tb
            a_contract = sa is not None and sa[0] == (0 if ta else 1)
            b_contract = sb is not None and sb[0] == (1 if tb else 0)
            if a_contract or b_contract:
                a_zero = a_contract and sa[1] == _ZERO
                b_zero = b_contract and sb[1] == _ZERO
                if not ((a_zero and fin(sb)) or (b_zero and fin(sa))):
                    return unsafe(node, "contraction over the padded "
                                        "dimension of a non-zero operand")
            row_pad = sa is not None and sa[0] == (1 if ta else 0)
            col_pad = sb is not None and sb[0] == (0 if tb else 1)
            if row_pad and col_pad:
                return unsafe(node, "both result axes would be padded")
            if not row_pad and not col_pad:
                state[node.nid] = None          # contracted away: exact
            else:
                src = sa if row_pad else sb
                sev = _NAN if any(s is not None and s[1] == _NAN
                                  for s in sts) else \
                    (_ZERO if src[1] == _ZERO else _FIN)
                state[node.nid] = (0 if row_pad else 1, sev)
        elif node.op in ir.AGG_OPS and "axis" in node.attrs:
            s = sts[0]
            reduced = {"full": (0, 1), "row": (1,), "col": (0,)}[
                node.attrs["axis"]]
            if s[0] in reduced:
                if op in ("sum", "sum_sq") and s[1] == _ZERO:
                    state[node.nid] = None      # zeros add nothing: exact
                else:
                    return unsafe(node, f"{op} over the padded dimension "
                                        "of a non-zero operand")
            else:
                state[node.nid] = s             # row-local: confined
        elif op in ir.UNARY_OPS:
            ax, sev = sts[0]
            if sev == _ZERO:
                sev = _ZERO if op in ir.SPARSE_SAFE_UNARY else \
                    (_FIN if op in _FIN_AT_ZERO else _NAN)
            elif sev == _FIN and op in _NAN_RISK:
                sev = _NAN
            state[node.nid] = (ax, sev)
        elif op in ir.BINARY_OPS:
            axes = {s[0] for s in sts if s is not None}
            if len(axes) != 1:
                return unsafe(node, "operands carry different padded axes")
            ax = axes.pop()
            sevs = [s[1] if s is not None else None for s in sts]
            if op in ("eq", "neq", "lt", "le", "gt", "ge"):
                sev = _FIN                       # 0/1 output
            elif op == "mul":
                if (sevs[0] == _ZERO and fin(sts[1])) or \
                        (sevs[1] == _ZERO and fin(sts[0])):
                    sev = _ZERO
                elif _NAN in sevs:
                    sev = _NAN
                else:
                    sev = _FIN
            elif op in ("div", "pow"):
                sev = _NAN                       # 0/0, x/0, 0**-1 …
            else:                                # add/sub/min/max
                if sevs[0] == _ZERO and sevs[1] == _ZERO:
                    sev = _ZERO
                else:
                    sev = _NAN if _NAN in sevs else _FIN
            state[node.nid] = (ax, sev)
        elif op in ir.TERNARY_OPS:
            axes = {s[0] for s in sts if s is not None}
            if len(axes) != 1:
                return unsafe(node, "operands carry different padded axes")
            sev = _NAN if any(s is not None and s[1] == _NAN
                              for s in sts) else _FIN
            state[node.nid] = (axes.pop(), sev)
        else:                                    # diagv, unknown ops
            return unsafe(node, "no padding rule for this operator")

    out_axes = tuple(state[o.nid][0] if state.get(o.nid) is not None
                     else None for o in graph.outputs)
    return PadReport(True, out_axes)


# --------------------------------------------------------------------------
# shape classes
# --------------------------------------------------------------------------

def _shape_class(shapes: dict[str, tuple[int, int]],
                 pad_to: int) -> Optional[tuple[dict, frozenset, int]]:
    """Padded shape class for one request's canonical operand shapes.

    The "batch rows" dimension ``m`` is the largest leading dimension
    that does **not** also appear as any operand's column dimension —
    column dimensions are feature/contraction axes (``w`` in
    ``hinge(X(m,64), w(64,1), y(m,1))`` leads with the feature dim 64;
    excluding column dims picks ``m`` rows, not features).  ``m``
    rounds up to the next multiple of ``pad_to`` and every operand led
    by ``m`` pads with it.  Returns ``(padded shapes, padded operand
    names, m)``, or None when no unambiguous batch dimension exists
    (all leading dims ≤ 1 or double as column dims — e.g. square
    matrices); those requests batch only with exact shape twins."""
    if pad_to <= 1 or not shapes:
        return None
    col_dims = {c for _r, c in shapes.values()}
    cands = {r for r, _c in shapes.values() if r > 1 and r not in col_dims}
    if not cands:
        return None
    m = max(cands)
    big = -(-m // pad_to) * pad_to
    padded = {n: ((big, c) if r == m else (r, c))
              for n, (r, c) in shapes.items()}
    names = frozenset(n for n, (r, _c) in shapes.items() if r == m)
    return padded, names, m


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def _uncanon(v: torch.Tensor):
    """The output half of the canonicalization round-trip (mirrors
    ``repro_torch.core.api._uncanon_output`` for sliced results): (n, 1)
    columns → 1-D, (1, 1) → 0-D."""
    if v.shape == (1, 1):
        return v.reshape(())
    if v.ndim == 2 and v.shape[1] == 1:
        return v.reshape(-1)
    return v


def _slice_back(t: "_Ticket", outs):
    """One request's result from its outputs at class shapes: each output
    cut back along its padded axis (``entry.out_axes``) to the request's
    ``m`` rows, then the 1-D/0-D round trip where the request had
    vectors.  The batched and per-request tiers share it."""
    vals = []
    for k, v in enumerate(outs):
        ax = t.entry.out_axes[k]
        if ax == 0 and t.m and v.dim() >= 1 and v.shape[0] != t.m:
            v = v[:t.m]
        elif ax == 1 and t.m and v.dim() >= 2 and v.shape[1] != t.m:
            v = v[:, :t.m]
        vals.append(_uncanon(v) if t.vector_world else v)
    return vals[0] if len(vals) == 1 else tuple(vals)


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

class CircuitBreaker:
    """Per-key (plan digest / build key) failure quarantine.

    State machine per key: **closed** (normal; consecutive failures
    count up) → **open** after ``threshold`` consecutive failures (every
    ``allow`` rejects) → **half_open** once ``cooldown_s`` elapses (one
    probe request is admitted; concurrent requests keep rejecting) →
    **closed** on probe success / back to **open** on probe failure.
    Success in any state resets the failure count."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 metrics: Optional[ServerMetrics] = None) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._keys: dict[str, dict] = {}

    def _rec(self, key: str) -> dict:
        rec = self._keys.get(key)
        if rec is None:
            rec = {"state": "closed", "fails": 0, "opened_at": 0.0,
                   "probing": False, "opens": 0, "label": ""}
            self._keys[key] = rec
        return rec

    def allow(self, key: str) -> tuple[bool, str]:
        """(admit?, state).  Transitions open → half_open after the
        cooldown and marks the admitted request as the probe."""
        with self._lock:
            rec = self._keys.get(key)
            if rec is None or rec["state"] == "closed":
                return True, "closed"
            now = time.perf_counter()
            if rec["state"] == "open":
                if now - rec["opened_at"] < self.cooldown_s:
                    return False, "open"
                rec["state"] = "half_open"
                rec["probing"] = False
                if self.metrics is not None:
                    self.metrics.on_breaker("probes")
            if rec["probing"]:                  # one probe at a time
                return False, "half_open"
            rec["probing"] = True
            return True, "half_open"

    def cancel_probe(self, key: str) -> None:
        """The admitted probe was never executed (e.g. rejected later
        in submit): release the probe slot."""
        with self._lock:
            rec = self._keys.get(key)
            if rec is not None:
                rec["probing"] = False

    def record_success(self, key: str) -> None:
        with self._lock:
            rec = self._keys.get(key)
            if rec is None:
                return                          # untracked: stay silent
            closed = rec["state"] != "closed"
            rec.update(state="closed", fails=0, probing=False)
            if closed and self.metrics is not None:
                self.metrics.on_breaker("closes")

    def record_failure(self, key: str, label: str = "") -> None:
        with self._lock:
            rec = self._rec(key)
            if label:
                rec["label"] = label
            rec["fails"] += 1
            rec["probing"] = False
            opened = False
            if rec["state"] == "half_open":     # failed probe: re-open
                opened = True
            elif rec["state"] == "closed" and \
                    rec["fails"] >= self.threshold:
                opened = True
            if opened:
                rec["state"] = "open"
                rec["opened_at"] = time.perf_counter()
                rec["opens"] += 1
                if self.metrics is not None:
                    self.metrics.on_breaker("opens")

    def state(self, key: str) -> str:
        with self._lock:
            rec = self._keys.get(key)
            return rec["state"] if rec is not None else "closed"

    def snapshot(self) -> list[dict]:
        """Per-key breaker state for reports — quarantined plans are
        the entries with ``state != "closed"``."""
        with self._lock:
            return [{"key": k, "state": r["state"], "fails": r["fails"],
                     "opens": r["opens"], "label": r["label"]}
                    for k, r in self._keys.items()]


def _all_finite(out) -> bool:
    if isinstance(out, tuple):
        return all(_all_finite(o) for o in out)
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out).all())
    return bool(np.isfinite(np.asarray(out)).all())


def _wait(device: torch.device) -> None:
    """Block until the work queued on ``device``'s current stream so far
    (the batch's kernels) has finished: an event per batch."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def _to_device(v, device: torch.device):
    """One operand carried to the server's device, keeping its format and
    rank (the Compiled call still sees 1-D / 0-D operands as such)."""
    if isinstance(v, (BCSR, DictCompressed)):
        return v.to(device)
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    if isinstance(v, np.ndarray):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    return v


# --------------------------------------------------------------------------
# entries & tickets
# --------------------------------------------------------------------------

@dataclass
class _PlanEntry:
    """One compiled (region × shape class × context) unit: the batching
    currency.  ``digest`` is the structural whole-plan signature —
    entries from *different* region objects with equal digests land in
    the same batch bucket and share one staged plan function."""
    label: str
    compiled: Compiled
    planned: Planned
    call_order: list[str]
    class_shapes: dict[str, tuple[int, int]]
    padded_names: frozenset
    out_axes: tuple
    n_outputs: int
    batchable: bool
    digest: str
    pad_safe: bool
    batched_fn: Optional[object] = field(default=None, repr=False)
    #: build-ladder outcome: "batched" | "exact" | "per_op"
    build_tier: str = "batched"
    per_op_fn: Optional[Compiled] = field(default=None, repr=False)

    @property
    def bucket_key(self) -> tuple:
        # unbatchable entries never co-batch: bucket by identity
        return ("plan", self.digest, tuple(sorted(self.class_shapes.items()))) \
            if self.batchable else ("entry", id(self))

    def per_op(self) -> Compiled:
        """The bottom ladder tier: per-operator interpreted dispatch
        (``staged=False``) — no whole-plan cache involved.  Built lazily
        on first degradation; a racing duplicate build is benign (the
        operator-level plan cache is shared)."""
        if self.per_op_fn is None:
            self.per_op_fn = self.planned.compile(staged=False)
        return self.per_op_fn


@dataclass
class _Ticket:
    entry: _PlanEntry
    pos: list                      # canonical tensors, call_order, unpadded
    kw: dict                       # operands on the device (unbatchable)
    m: int                         # true leading dim (0: nothing padded)
    padded: bool
    vector_world: bool
    future: Future
    t_submit: float
    deadline: Optional[float] = None   # absolute perf_counter, or None
    budget: int = 8                    # remaining re-execution charges


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

class FusionServer:
    """Async multi-tenant server over compiled fused plans.

    Parameters
    ----------
    workers
        Queue-draining threads.  PyTorch releases the GIL inside its ops
        and the kernels run asynchronously on the card, so >1 worker
        overlaps one batch's marshalling with another's kernels.
        ``workers=0`` builds a warm-only server (``warm()`` /
        ``warmed_plans()`` work; ``submit`` raises) until ``start()``
        is called; then it admits requests and the caller serves them
        with :meth:`drain`.
    max_batch
        Requests per batched dispatch.  Batch sizes are padded up to
        powers of two (≤ ``max_batch``), as in the reference, so a
        bucket sees O(log max_batch) batch shapes.  ``max_batch=1`` is
        the per-request-dispatch baseline.
    pad_to
        Leading-dimension quantum of the shape classes (`0`/`1`
        disables padding: only exact shapes batch).
    context
        :class:`FusionContext` every request plans under (default: the
        scoped context at construction); its ``device`` is where
        operands, batches and results live, its ``kernels`` the policy of
        every ladder tier.  Sparse and compressed operands are served
        unbatched (per request, at the exact-shape tier).
    plan_cache_capacity / whole_plan_cache_capacity
        Optional resize of the two global LRU plan caches — the
        lifecycle knob for long-lived processes churning through many
        plan structures.
    max_queue
        Bound on the admission queue (0: unbounded).  A full queue
        rejects at ``submit`` with :class:`QueueFullError` — typed
        backpressure instead of unbounded memory growth.
    default_deadline_s
        Deadline applied to every request that does not pass its own
        ``deadline_s`` to ``submit`` (None: no deadline).  Expired
        requests resolve with :class:`DeadlineExceededError` at dequeue
        and at every degradation step; an execution already in flight
        runs to completion.
    retry_budget
        Re-execution charges per request: each bisection half-dispatch
        and each ladder tier costs one.  Exhaustion resolves the future
        with :class:`RequestFailedError` (cause chained).
    check_finite
        Verify every tier's outputs are finite; NaN/Inf results degrade
        down the ladder and, if reproduced at the bottom, fail with
        :class:`NonFiniteOutputError`.  Off by default (an
        ``isfinite`` scan per output, read back to the host).
    breaker_threshold / breaker_cooldown_s
        Circuit-breaker tuning: consecutive tier-0 failures before a
        plan digest is quarantined, and how long before a half-open
        probe is admitted.  ``server.breaker.snapshot()`` lists
        quarantined plans; so does ``metrics.report(server)``.
    """

    def __init__(self, *, workers: int = 2, max_batch: int = 16,
                 pad_to: int = 64, context: Optional[FusionContext] = None,
                 plan_cache_capacity: Optional[int] = None,
                 whole_plan_cache_capacity: Optional[int] = None,
                 autostart: bool = True,
                 max_queue: int = 0,
                 default_deadline_s: Optional[float] = None,
                 retry_budget: int = 8,
                 check_finite: bool = False,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0):
        self.workers = int(workers)
        self.max_batch = max(1, int(max_batch))
        self.pad_to = max(0, int(pad_to))
        self.max_queue = max(0, int(max_queue))
        self.default_deadline_s = default_deadline_s
        self.retry_budget = max(0, int(retry_budget))
        self.check_finite = bool(check_finite)
        self._ctx = context if context is not None else current_context()
        self.device = resolve_device(self._ctx.device)
        if plan_cache_capacity is not None:
            PLAN_CACHE.resize(plan_cache_capacity)
        if whole_plan_cache_capacity is not None:
            WHOLE_PLAN_CACHE.resize(whole_plan_cache_capacity)
        self.metrics = ServerMetrics()
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s,
                                      metrics=self.metrics)
        self._queue: "deque[_Ticket]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._closed = False
        self._entry_lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _PlanEntry]" = OrderedDict()
        self._routes: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._threads: list[threading.Thread] = []
        self._started = False
        if autostart and self.workers > 0:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Spin up the worker threads (idempotent).  A server built with
        ``workers=0`` starts with none: it admits requests, and serves
        them only when the caller runs :meth:`drain`."""
        if self._started:
            return
        self._started = True
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"fusion-serve-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the workers, reject new submissions, and resolve every
        still-queued ticket with :class:`ServerClosedError` — a
        submitted request's future never stays pending forever."""
        with self._cv:
            self._closed = True
            self._stop = True
            self._cv.notify_all()
        # a crashing worker may respawn a replacement concurrently with
        # close(); join until the thread list stops changing
        for _ in range(4):
            with self._cv:
                threads = list(self._threads)
            if not threads:
                break
            for t in threads:
                t.join(timeout=timeout)
            with self._cv:
                self._threads = [t for t in self._threads if t.is_alive()]
                if not self._threads:
                    break
        with self._cv:
            leftover, self._queue = list(self._queue), deque()
        for t in leftover:
            if not t.future.done():
                t.future.set_exception(ServerClosedError(
                    "FusionServer closed while the request was queued"))
                self.metrics.on_cancel()

    def __enter__(self) -> "FusionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission -----------------------------------------------------------
    def submit(self, region, *args, deadline_s: Optional[float] = None,
               retries: Optional[int] = None, **kwargs) -> Future:
        """Enqueue one invocation of ``region`` (a ``fused`` wrapper) on
        the given operands; returns a :class:`concurrent.futures.Future`
        resolving to the same values and shapes ``region(*args,
        **kwargs)`` would return (same 1-D/0-D canonicalization
        round-trip), as tensors on the server's device: views into the
        batch's outputs, ready once the batch's kernels have finished.
        Operands are carried to the device here, once.  Typed :class:`FusionServeError`\\ s are raised *here*
        — a request that cannot be served is never enqueued.

        ``deadline_s`` / ``retries`` override the server's
        ``default_deadline_s`` / ``retry_budget`` per request (they are
        control parameters, not operands — a region operand with either
        name must be passed positionally)."""
        if self._closed:
            self.metrics.on_reject()
            raise ServerClosedError("submit on a closed FusionServer")
        if not self._started:
            self.metrics.on_reject()
            raise ServerClosedError(
                "FusionServer is not started; call start() or construct "
                "with autostart=True and workers > 0")
        names = getattr(region, "names", None)
        if names is None or not hasattr(region, "trace"):
            self.metrics.on_reject()
            raise FusionServeError(
                f"submit expects a fused region (repro_torch.core.Fused), "
                f"got {type(region).__name__}")
        bound = dict(zip(names, args))
        bound.update(kwargs)
        if set(bound) != set(names):
            self.metrics.on_reject()
            missing = set(names) - set(bound)
            extra = set(bound) - set(names)
            raise AdmissionError(
                f"operands do not match region signature {names}: "
                f"missing {sorted(missing)}, unexpected {sorted(extra)}")
        try:
            shapes = {n: _canon_shape(n, v)[0] for n, v in bound.items()}
            vector_world = any(_canon_shape(n, v)[1] < 2
                               for n, v in bound.items())
        except TypeError as e:          # FusionInputError subclasses this
            self.metrics.on_reject()
            raise AdmissionError(str(e)) from e
        if self.max_queue and len(self._queue) >= self.max_queue:
            # early check outside the lock keeps the breaker's probe
            # accounting clean; the authoritative check is at enqueue
            self.metrics.on_reject("backpressure")
            raise QueueFullError(
                f"admission queue is full ({self.max_queue} requests); "
                "shed load or retry with backoff")
        entry, m, was_padded = self._route(region, bound, shapes)
        allowed, state = self.breaker.allow(entry.digest)
        if not allowed:
            self.metrics.on_reject("quarantined")
            raise PlanQuarantinedError(
                f"plan {entry.digest} ({entry.label}) is quarantined by "
                f"the circuit breaker (state={state}); retry after the "
                f"cooldown ({self.breaker.cooldown_s}s)")
        deadline = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        budget = retries if retries is not None else self.retry_budget
        if entry.batchable or entry.padded_names:
            # carry the operands to the device here, in the client's
            # thread — worker time is the serving bottleneck, submit time
            # is not.  padded-class entries need them even when
            # unbatchable (a degraded build serves the class per-request
            # at class shapes: same zero-fill marshalling, batch of one)
            pos = [_canon_value(n, bound[n], self.device).detach()
                   for n in entry.call_order]
            kw = {}
        else:
            pos = []
            kw = {n: _to_device(v, self.device) for n, v in bound.items()}
        now = time.perf_counter()
        ticket = _Ticket(entry=entry, pos=pos, kw=kw, m=m,
                         padded=was_padded, vector_world=vector_world,
                         future=Future(), t_submit=now,
                         deadline=None if deadline is None
                         else now + float(deadline),
                         budget=max(0, int(budget)))
        with self._cv:
            if self.max_queue and len(self._queue) >= self.max_queue:
                self.breaker.cancel_probe(entry.digest)
                self.metrics.on_reject("backpressure")
                raise QueueFullError(
                    f"admission queue is full ({self.max_queue} "
                    "requests); shed load or retry with backoff")
            self._queue.append(ticket)
            depth = len(self._queue)
            self._cv.notify()
        self.metrics.on_submit(depth)
        return ticket.future

    # -- routing: request shapes → compiled entry ----------------------------
    def _route(self, region, bound: dict,
               shapes: dict) -> tuple[_PlanEntry, int, bool]:
        fmts = tuple(
            "bcsr" if isinstance(bound[n], BCSR) else
            "dict" if isinstance(bound[n], DictCompressed) else "dense"
            for n in region.names)
        rkey = (id(region), tuple(shapes[n] for n in region.names), fmts,
                self._ctx.key())
        with self._entry_lock:
            hit = self._routes.get(rkey)
            if hit is not None:
                self._routes.move_to_end(rkey)
                return hit
            route = self._build_route(region, bound, shapes, fmts)
            self._routes[rkey] = route
            while len(self._routes) > 4096:
                self._routes.popitem(last=False)
            return route

    def _build_route(self, region, bound, shapes, fmts):
        batchable = all(f == "dense" for f in fmts) and self.max_batch > 1
        cls = _shape_class(shapes, self.pad_to) if batchable else None
        pad_fallback = False
        if cls is not None:
            padded_shapes, padded_names, _m = cls
            # always analyze: a boundary-exact request (padding a no-op
            # for it) still joins a class that later requests pad into
            try:
                traced = region.trace(**{
                    n: torch.empty(padded_shapes[n], device="meta")
                    for n in region.names})
                report = pad_safety(traced.graph, padded_names)
            except Exception:       # padding broke trace-time shape rules
                report = PadReport(False, (), "trace failed at padded shapes")
            if not report.safe:
                pad_fallback = True
                cls = None
        if cls is not None:
            class_shapes, padded_names, m = cls
        else:
            class_shapes, padded_names, m = dict(shapes), frozenset(), 0
        entry = self._entry(region, bound, class_shapes, padded_names,
                            fmts, batchable, pad_fallback)
        was_padded = bool(padded_names) and class_shapes != shapes
        return entry, m, was_padded

    def _entry(self, region, bound, class_shapes, padded_names, fmts,
               batchable, pad_fallback) -> _PlanEntry:
        ekey = (id(region), tuple(sorted(class_shapes.items())), fmts,
                self._ctx.key())
        hit = self._entries.get(ekey)
        if hit is not None:
            return hit
        name = getattr(region.fn, "__name__", "<expr>")
        dims = "/".join(f"{r}x{c}" for r, c in
                        (class_shapes[n] for n in region.names))
        label = f"{name}[{dims}]"
        # build circuit breaker: a compile failure that recurs on every
        # retry must not cost a full rebuild per submit
        bkey = "build:" + WholePlanCache.key_digest(ekey)
        allowed, state = self.breaker.allow(bkey)
        if not allowed:
            self.metrics.on_reject("quarantined")
            raise PlanQuarantinedError(
                f"plan compile for {label} is quarantined after repeated "
                f"build failures (state={state}); retry after the "
                f"cooldown ({self.breaker.cooldown_s}s)")
        t0 = time.perf_counter()
        operands = {}
        for n in region.names:
            v = bound[n]
            if isinstance(v, (BCSR, DictCompressed)):
                operands[n] = v              # trace reads shape + density
            else:
                operands[n] = torch.empty(class_shapes[n], device="meta")
        try:
            traced = region.trace(**operands)
            planned = traced.plan(context=self._ctx)
        except Exception as e:
            self.breaker.record_failure(bkey, label=label)
            raise PlanCompileError(
                f"trace/plan failed for {label}: {e}") from e
        if padded_names:
            report = pad_safety(traced.graph, padded_names)
            assert report.safe, "pad-checked class re-verified unsafe"
            out_axes = report.out_axes
        else:
            out_axes = tuple(None for _ in traced.graph.outputs)
        # build ladder: batched plan function (request-axis kernels, built
        # with nvcc here on the card) → exact-shape staged → per-op
        # (staged=False).  Each degradation is recorded in the runtime-
        # fallback ledger; total build failure opens the build breaker.
        compiled = batched_fn = None
        build_tier = "batched" if batchable else "exact"
        if batchable:
            try:
                compiled = planned.compile()
                batched_fn = compiled.batched()
            except Exception as e:           # noqa: BLE001 — degrade
                self.metrics.on_runtime_fallback(
                    "plan.build",
                    f"batched plan-function build failed for {label} "
                    f"({type(e).__name__}: {e}); serving exact-shape "
                    "per-request", tier="exact")
                compiled, batchable, build_tier = None, False, "exact"
        if compiled is None:
            try:
                compiled = planned.compile()
            except Exception as e:           # noqa: BLE001 — degrade
                self.metrics.on_runtime_fallback(
                    "plan.build",
                    f"staged compile failed for {label} "
                    f"({type(e).__name__}: {e}); serving per-op "
                    "staged=False", tier="per_op")
                try:
                    compiled = planned.compile(staged=False)
                    build_tier = "per_op"
                except Exception as e2:
                    self.breaker.record_failure(bkey, label=label)
                    raise PlanCompileError(
                        f"no executable exists for {label} on any ladder "
                        f"tier: {e2}") from e2
        self.breaker.record_success(bkey)
        digest = WholePlanCache.key_digest(compiled.plan_key())
        entry = _PlanEntry(
            label=label, compiled=compiled, planned=planned,
            call_order=compiled.input_order, class_shapes=class_shapes,
            padded_names=padded_names, out_axes=out_axes,
            n_outputs=len(traced.graph.outputs), batchable=batchable,
            digest=digest, pad_safe=not pad_fallback,
            build_tier=build_tier)
        if build_tier == "per_op":
            entry.per_op_fn = compiled
        if batchable:
            entry.batched_fn = batched_fn
        self._entries[ekey] = entry
        self.metrics.on_compile(digest, time.perf_counter() - t0,
                                pad_fallback=pad_fallback)
        return entry

    # -- warming -------------------------------------------------------------
    def warm(self, regions, execute: bool = True,
             batch_sizes: tuple = (1,)) -> dict:
        """Compile plans ahead of traffic.  ``regions`` is an iterable of
        ``(region, operands)`` pairs — operands as arrays, tensors or
        meta tensors (each distinct shape class to serve should be
        warmed).  ``execute=True`` additionally runs each entry on zeros
        — batchable entries once per batch size in ``batch_sizes``
        (warming ``(1, 2, ..., max_batch)`` keeps first-launch costs out
        of the serving path), unbatchable entries once through the plain
        compiled call.  Returns a
        warming report (per-entry label/digest + cache stats)."""
        rows = []
        for region, operands in regions:
            names = getattr(region, "names", None)
            if names is None or set(operands) != set(names):
                raise FusionServeError(
                    f"warm: operands do not match region signature {names}")
            shapes = {n: _canon_shape(n, v)[0]
                      for n, v in operands.items()}
            entry, _m, _p = self._route(region, operands, shapes)
            with torch.no_grad():
                if execute and entry.batchable:
                    for b in batch_sizes:
                        bc = _pow2_at_least(int(b), self.max_batch)
                        zeros = []
                        for n in entry.call_order:
                            z = build.batch_empty(bc, entry.class_shapes[n],
                                                  self.device)
                            zeros.append(z.zero_())
                        entry.batched_fn(*zeros)
                elif execute and not any(
                        isinstance(v, (BCSR, DictCompressed))
                        for v in operands.values()):
                    zeros = {n: torch.zeros(entry.class_shapes[n],
                                            device=self.device)
                             for n in entry.call_order}
                    entry.compiled(**zeros)
            _wait(self.device)
            rows.append({"label": entry.label, "digest": entry.digest,
                         "batchable": entry.batchable,
                         "pad_safe": entry.pad_safe})
        from dataclasses import asdict
        from repro_torch.core import whole_plan_cache_stats
        return {"entries": rows,
                "whole_plan_cache": asdict(whole_plan_cache_stats())}

    def warmed_plans(self) -> list[tuple[str, Planned]]:
        """(label, Planned) for every compiled entry — the hook
        a linter uses to strict-verify exactly the plans the serving
        path executes."""
        with self._entry_lock:
            return [(e.label, e.planned) for e in self._entries.values()]

    # -- worker --------------------------------------------------------------
    def _worker_loop(self) -> None:
        batch: list[_Ticket] = []
        torch.set_grad_enabled(False)          # this thread only
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._stop:
                        self._cv.wait(timeout=0.1)
                    if not self._queue:
                        if self._stop:
                            return
                        continue
                    batch, depth = self._take_batch()
                faults.fault_point("serve.worker")
                self._execute(batch, depth)
                batch = []
        except BaseException as e:        # noqa: BLE001 — crash: respawn
            self._on_worker_crash(batch, e)

    def _take_batch(self) -> tuple[list[_Ticket], int]:
        """Under ``_cv``, with the queue not empty: pop the head ticket and
        up to ``max_batch - 1`` more of its bucket, in queue order; the
        others keep their places.  Returns (batch, queue depth left)."""
        head = self._queue.popleft()
        batch = [head]
        if self.max_batch > 1:
            rest: "deque[_Ticket]" = deque()
            bk = head.entry.bucket_key
            while self._queue:
                t = self._queue.popleft()
                if len(batch) < self.max_batch and \
                        t.entry.bucket_key == bk:
                    batch.append(t)
                else:
                    rest.append(t)
            self._queue.extend(rest)
        return batch, len(self._queue)

    def drain(self) -> int:
        """Serve every queued request in the calling thread, batch by
        batch as a worker does, and return the number of batches taken.
        This is how a started server with ``workers=0`` serves: its
        batches are exactly the requests submitted before the call, and
        their host time is the worker's, without threads."""
        n = 0
        with torch.no_grad():
            while True:
                with self._cv:
                    if not self._queue:
                        return n
                    batch, depth = self._take_batch()
                self._execute(batch, depth)
                n += 1

    def _on_worker_crash(self, inflight: list[_Ticket], err) -> None:
        """Crash containment: requeue the dead worker's unresolved
        tickets at the queue front and spawn a replacement thread — the
        pool never shrinks silently."""
        self.metrics.on_worker_crash(type(err).__name__)
        me = threading.current_thread()
        replacement = None
        with self._cv:
            pending = [t for t in inflight if not t.future.done()]
            self._queue.extendleft(reversed(pending))
            if pending:
                self.metrics.on_requeue(len(pending))
            try:
                self._threads.remove(me)
            except ValueError:
                pass
            if not self._stop:
                replacement = threading.Thread(
                    target=self._worker_loop, name=me.name, daemon=True)
                self._threads.append(replacement)
                self.metrics.on_worker_respawn()
            self._cv.notify_all()
        if replacement is not None:
            replacement.start()

    # -- execution: tier-0 dispatch, bisection, degradation ladder -----------
    def _execute(self, batch: list[_Ticket], depth: int) -> None:
        batch = [t for t in batch if not self._expire(t)]
        if not batch:
            return
        entry = batch[0].entry
        if entry.batchable:
            self._dispatch(entry, batch, depth)
        else:
            for t in batch:              # isolation: one future per try
                self._single(t, depth)

    def _expire(self, t: _Ticket) -> bool:
        """Deadline check at dequeue and at every ladder step."""
        if t.future.done():
            return True
        if t.deadline is not None and time.perf_counter() > t.deadline:
            t.future.set_exception(DeadlineExceededError(
                f"deadline passed before {t.entry.label} finished"))
            self.metrics.on_deadline(t.entry.digest)
            return True
        return False

    def _charge(self, t: _Ticket, cause: Exception) -> bool:
        """Spend one re-execution charge; False (and a terminal typed
        error on the future) when the budget is exhausted."""
        if t.future.done():
            return False
        if t.budget <= 0:
            err = RequestFailedError(
                f"retry budget exhausted for {t.entry.label}: "
                f"{type(cause).__name__}: {cause}")
            err.__cause__ = cause
            t.future.set_exception(err)
            self.metrics.on_retries_exhausted(t.entry.digest)
            self.metrics.on_result(t.entry.digest, None, failed=True)
            return False
        t.budget -= 1
        return True

    def _dispatch(self, entry: _PlanEntry, batch: list[_Ticket],
                  depth: int) -> None:
        """Tier 0: one batched dispatch.  Failure bisects the
        batch (poison-request isolation: a bad operand fails only its
        own future) and sends singletons down the degradation ladder."""
        try:
            rule = faults.fault_point("serve.batch_dispatch")
            per = self._run_batched(entry, batch)
            if rule is not None:         # injected nonfinite: poison
                per = [faults.poison(p) for p in per]
        except Exception as e:            # noqa: BLE001 — ladder
            self.metrics.on_dispatch(entry.digest, len(batch), 0, depth,
                                     failed=True)
            self.breaker.record_failure(entry.digest, label=entry.label)
            if len(batch) == 1:
                t = batch[0]
                if not self._expire(t) and self._charge(t, e):
                    self._degrade(t, e, depth)
                return
            self.metrics.on_bisect()
            self.metrics.on_runtime_fallback(
                "serve.batch_dispatch",
                f"batched dispatch of {len(batch)} requests failed "
                f"({type(e).__name__}); bisecting to isolate the poison "
                "request", tier="bisect")
            mid = len(batch) // 2
            for half in (batch[:mid], batch[mid:]):
                half = [t for t in half
                        if not self._expire(t) and self._charge(t, e)]
                if half:
                    self._dispatch(entry, half, depth)
            return
        self.breaker.record_success(entry.digest)
        now = time.perf_counter()
        self.metrics.on_dispatch(entry.digest, len(batch),
                                 sum(1 for t in batch if t.padded), depth)
        for t, outs in zip(batch, per):
            if t.future.done():
                continue
            if self.check_finite and not _all_finite(outs):
                err = NonFiniteOutputError(
                    f"batched result for {t.entry.label} is non-finite")
                self.metrics.on_nonfinite(entry.digest)
                if self._charge(t, err):
                    self._degrade(t, err, depth)
                continue
            t.future.set_result(outs)
            self.metrics.on_result(entry.digest,
                                   (now - t.t_submit) * 1e6)

    def _single(self, t: _Ticket, depth: int) -> None:
        """Unbatchable (sparse / compressed / degraded-build) path: tier 0
        is the exact-shape staged call; failures continue at per-op."""
        if self._expire(t):
            return
        try:
            faults.fault_point("serve.batch_dispatch")
            out = self._run_tier(t, t.entry.compiled)
            if self.check_finite and not _all_finite(out):
                self.metrics.on_nonfinite(t.entry.digest)
                raise NonFiniteOutputError(
                    f"result for {t.entry.label} is non-finite")
        except Exception as e:            # noqa: BLE001 — ladder
            self.metrics.on_dispatch(t.entry.digest, 1, 0, depth,
                                     failed=True)
            self.breaker.record_failure(t.entry.digest,
                                        label=t.entry.label)
            if self._charge(t, e):
                self._degrade(t, e, depth, tiers=("per_op",))
            return
        self.breaker.record_success(t.entry.digest)
        self.metrics.on_dispatch(t.entry.digest, 1, 0, depth)
        t.future.set_result(out)
        self.metrics.on_result(t.entry.digest,
                               (time.perf_counter() - t.t_submit) * 1e6)

    def _degrade(self, t: _Ticket, cause: Exception, depth: int,
                 tiers: tuple = ("exact", "per_op")) -> None:
        """Walk the remaining ladder tiers for one request.  Every
        degradation is recorded in the runtime-fallback ledger — the
        run-time extension of ``record_fallback`` — and charged against
        the retry budget.  The bottom of the ladder is a typed terminal
        error chaining the original cause."""
        entry = t.entry
        for i, tier in enumerate(tiers):
            if self._expire(t):
                return
            if i > 0 and not self._charge(t, cause):
                return
            try:
                if tier == "exact":
                    out = self._run_tier(t, entry.compiled)
                else:
                    out = self._run_tier(t, entry.per_op())
                if self.check_finite and not _all_finite(out):
                    self.metrics.on_nonfinite(entry.digest)
                    raise NonFiniteOutputError(
                        f"{tier} result for {entry.label} is non-finite")
            except Exception as e:        # noqa: BLE001 — next tier
                cause = e
                continue
            self.metrics.on_degrade(tier, entry.digest)
            self.metrics.on_runtime_fallback(
                "serve.batch_dispatch",
                f"request re-executed at tier '{tier}' after "
                f"{type(cause).__name__}", tier=tier)
            t.future.set_result(out)
            self.metrics.on_result(entry.digest,
                                   (time.perf_counter() - t.t_submit) * 1e6)
            return
        if t.future.done():
            return
        if isinstance(cause, NonFiniteOutputError):
            t.future.set_exception(cause)
        else:
            err = RequestFailedError(
                f"every degradation tier failed for {entry.label}: "
                f"{type(cause).__name__}: {cause}")
            err.__cause__ = cause
            t.future.set_exception(err)
        self.metrics.on_result(entry.digest, None, failed=True)

    def _run_tier(self, t: _Ticket, fn):
        """Run one request through ``fn`` — a Compiled at the entry's
        class shapes (staged exact tier or per-op tier).  Padded-class
        tickets marshal exactly like one request of the batched path:
        zero-fill up to class shapes on the device (the pad-safety
        analysis already proved that exact) and slice the outputs back.
        Exact-shape tickets pass their operands straight through — the
        Compiled call handles canonicalization and the 1-D/0-D round
        trip.  Returns once the request's kernels have finished."""
        entry = t.entry
        if not t.pos:
            out = fn(**t.kw)
            _wait(self.device)
            return out
        kwargs = {}
        for i, name in enumerate(entry.call_order):
            r, c = entry.class_shapes[name]
            v = t.pos[i]
            if tuple(v.shape) != (r, c):
                buf = torch.zeros((r, c), dtype=torch.float32,
                                  device=self.device)
                buf[:v.shape[0], :v.shape[1]] = v
                v = buf
            kwargs[name] = v
        out = fn(**kwargs)
        result = _slice_back(t, out if isinstance(out, tuple) else (out,))
        _wait(self.device)
        return result

    def _run_batched(self, entry: _PlanEntry,
                     batch: list[_Ticket]) -> list:
        # One stacked device buffer per operand, each request's slice
        # 16-byte aligned (the request-axis kernels read it in place): the
        # requests' rows are copied in and the rows past them zeroed (the
        # zero fill IS the padding) by one multi-tensor copy and one
        # multi-tensor fill per operand, not two ops per request (each
        # small device op costs the worker ~20 µs of host time); batch-
        # axis padding repeats request 0.  Device copies only, no host
        # round trip.
        B = len(batch)
        Bc = _pow2_at_least(B, self.max_batch)
        stacked = []
        for i, name in enumerate(entry.call_order):
            r, c = entry.class_shapes[name]
            buf = build.batch_empty(Bc, (r, c), self.device)
            dst, src, pad = [], [], []
            for j, t in enumerate(batch):
                v = t.pos[i]
                vr, vc = v.shape
                dst.append(buf[j, :vr, :vc])
                src.append(v)
                if vr < r:
                    pad.append(buf[j, vr:, :])
                if vc < c:
                    pad.append(buf[j, :vr, vc:])
            torch._foreach_copy_(dst, src)
            if pad:
                torch._foreach_zero_(pad)
            if Bc > B:                       # batch-axis padding
                buf[B:] = buf[0]
            stacked.append(buf)
        outs = entry.batched_fn(*stacked)
        _wait(self.device)                   # the batch's kernels are done
        return [_slice_back(t, [outs[k][j] for k in range(entry.n_outputs)])
                for j, t in enumerate(batch)]
