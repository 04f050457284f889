"""Code generation & runtime integration (paper §2.1-2.2) on one device,
over dense and BCSR operands.

Turns selected plans into executable operators and whole ExecPlans into
callables.  Two cache layers memoize the generated code, as in the
reference:

* the **plan cache** memoizes generated *operators* by structural CPlan
  hash (shapes/ops/binding/variant) — the paper's Fig. 11 mechanism; the
  CUDA kernel of an operator is further keyed by the hash of its generated
  source (:mod:`repro_torch.kernels.build`);
* the **whole-plan cache** memoizes the *staged plan function* — the
  entire ExecPlan (fused operators, basic ops, literals, multi-aggregate
  unpacking) as one callable — by structural plan signature, so
  structurally-equal plans share it.

``jax.jit`` of the plan function has no counterpart here: the plan
function runs eagerly, one kernel (or torch op) per step.  Literals are
(1,1) fp32 tensors built once per plan and device, dead intermediates are
released at their last use (``_last_uses``), and inputs are never
donated.  Execution paths per operator are chosen by
:func:`repro_torch.kernels.ops.execute`.

:meth:`CompiledPlan.batched_callable` is the counterpart of the
reference's ``jit(vmap(plan_fn))``: the same steps over inputs stacked on
a leading request axis, each fused step one call of the request-axis
kernel for the whole batch (:func:`repro_torch.kernels.ops.
execute_batched`), each basic step a batched torch op.
``compile_plan(staged=False)`` selects per-operator dispatch without the
whole-plan cache (:meth:`CompiledPlan._call_per_op`).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import torch

from repro_torch import faults
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.blocksparse import BCSR
from .cost import FusedOpSpec
from .cplan import CPlan, build_cplan
from .ir import Graph, Node
from .select import ExecPlan, MultiAggSpec
from .templates import TType


faults.register_site(
    "plan.build",
    "staged / batched plan-function build inside the whole-plan cache "
    "builder (first build per structural plan key; the batched build also "
    "generates and compiles its CUDA kernels)",
    kinds=("error", "latency"),
    handler="FusionServer._entry build ladder (batched → exact-shape → "
            "per-op) + build circuit breaker; failed builds are not "
            "cached, so retries rebuild")


def _mesh_of(layout):
    """Mesh carried by a layout-ish object (the port runs on one device:
    always None for the layouts it accepts)."""
    if layout is None:
        return None
    mesh = getattr(layout, "mesh", None)
    if mesh is None and hasattr(layout, "axis_names"):
        return layout
    return mesh


def _is_real_mesh(mesh) -> bool:
    """The port executes no device mesh yet: no mesh is executable."""
    return False


# --------------------------------------------------------------------------
# plan cache
# --------------------------------------------------------------------------

@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0
    codegen_time_s: float = 0.0

    @property
    def total(self) -> int:
        return self.hits + self.misses


class PlanCache:
    """Thread-safe LRU cache of generated operators keyed by structural
    CPlan hash.  Bounded: least-recently-used operators are evicted past
    ``maxsize`` (pass ``maxsize``, set ``REPRO_PLAN_CACHE_CAPACITY``, or
    call :meth:`resize` on a live cache)."""

    def __init__(self, maxsize: Optional[int] = None) -> None:
        if maxsize is None:
            import os
            maxsize = int(os.environ.get("REPRO_PLAN_CACHE_CAPACITY", 512))
        self.maxsize = int(maxsize)
        self._ops: "OrderedDict[str, GeneratedOp]" = OrderedDict()
        self._lock = threading.RLock()
        self.stats = PlanCacheStats(capacity=self.maxsize)

    def resize(self, maxsize: int) -> None:
        """Change the LRU capacity, evicting LRU entries past the new
        bound immediately."""
        with self._lock:
            self.maxsize = int(maxsize)
            self.stats.capacity = self.maxsize
            while len(self._ops) > self.maxsize:
                self._ops.popitem(last=False)
                self.stats.evictions += 1
            self.stats.size = len(self._ops)

    def get_or_build(self, graph: Graph, spec) -> tuple["GeneratedOp", CPlan]:
        """Returns (generated operator, this spec's CPlan).  The operator
        may come from a structurally-equal plan of a *different* graph, so
        callers bind inputs positionally via the returned CPlan."""
        t0 = time.perf_counter()
        cplan = build_cplan(graph, spec)
        key = cplan.cache_key()
        with self._lock:
            hit = self._ops.get(key)
            if hit is not None:
                self._ops.move_to_end(key)
                self.stats.hits += 1
                return hit, cplan
            op = GeneratedOp(cplan)
            self._ops[key] = op
            while len(self._ops) > self.maxsize:
                self._ops.popitem(last=False)
                self.stats.evictions += 1
            self.stats.misses += 1
            self.stats.size = len(self._ops)
            self.stats.codegen_time_s += time.perf_counter() - t0
            return op, cplan

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()
            self.stats = PlanCacheStats(capacity=self.maxsize)


PLAN_CACHE = PlanCache()


def plan_cache_stats() -> PlanCacheStats:
    """Snapshot of the global plan-cache counters (``hits`` / ``misses`` /
    ``total`` / ``evictions`` / ``size`` / ``capacity`` /
    ``codegen_time_s``)."""
    with PLAN_CACHE._lock:
        return replace(PLAN_CACHE.stats, size=len(PLAN_CACHE._ops),
                       capacity=PLAN_CACHE.maxsize)


# --------------------------------------------------------------------------
# whole-plan cache (staged plan functions, layered on the plan cache)
# --------------------------------------------------------------------------

@dataclass
class WholePlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0
    build_time_s: float = 0.0
    #: per-key stat records currently tracked / dropped past the bound
    tracked_keys: int = 0
    dropped_keys: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses


#: per-key stat records kept across entry churn (bounded separately from
#: the function LRU so eviction metrics survive the evicted entries)
KEY_STATS_CAPACITY = 4096


class WholePlanCache:
    """Thread-safe LRU of staged plan functions keyed by structural plan
    signature (per-operator CPlan hashes + env wiring + literals + kernel
    policy + device).  **Build-once:** :meth:`get_or_create` serializes
    concurrent misses on the same key — one thread builds, the rest wait
    and share the result.  **Lifecycle:** the LRU bound is configurable
    (``maxsize`` / ``REPRO_WHOLE_PLAN_CACHE_CAPACITY`` / :meth:`resize`)
    and per-key hit/miss/eviction/build-time counters (:meth:`key_stats`)
    survive entry eviction."""

    def __init__(self, maxsize: Optional[int] = None) -> None:
        if maxsize is None:
            import os
            maxsize = int(os.environ.get(
                "REPRO_WHOLE_PLAN_CACHE_CAPACITY", 256))
        self.maxsize = int(maxsize)
        self._fns: "OrderedDict[tuple, Callable]" = OrderedDict()
        self._lock = threading.RLock()
        self._pending: dict[tuple, threading.Event] = {}
        self._key_stats: "OrderedDict[str, dict]" = OrderedDict()
        self.stats = WholePlanCacheStats(capacity=self.maxsize)

    # -- per-key metrics ----------------------------------------------------
    @staticmethod
    def key_digest(key: tuple) -> str:
        """Short stable-within-process label for one structural key."""
        return format(hash(key) & 0xFFFFFFFFFFFF, "012x")

    def _key_record(self, key: tuple) -> dict:
        # caller holds the lock
        digest = self.key_digest(key)
        rec = self._key_stats.get(digest)
        if rec is None:
            rec = {"key": digest, "hits": 0, "misses": 0, "evictions": 0,
                   "build_time_s": 0.0}
            self._key_stats[digest] = rec
            while len(self._key_stats) > KEY_STATS_CAPACITY:
                self._key_stats.popitem(last=False)
                self.stats.dropped_keys += 1
        else:
            self._key_stats.move_to_end(digest)
        return rec

    def key_stats(self, top: Optional[int] = None) -> list[dict]:
        """Per-key counter records, most recently touched last; records
        outlive their cache entries (eviction is itself a counter)."""
        with self._lock:
            recs = [dict(r) for r in self._key_stats.values()]
        if top is not None:
            recs = recs[-top:]
        return recs

    # -- LRU ----------------------------------------------------------------
    def resize(self, maxsize: int) -> None:
        """Change the LRU capacity, evicting past the new bound now."""
        with self._lock:
            self.maxsize = int(maxsize)
            self.stats.capacity = self.maxsize
            self._evict_over_capacity()
            self.stats.size = len(self._fns)

    def _evict_over_capacity(self) -> None:
        # caller holds the lock
        while len(self._fns) > self.maxsize:
            old_key, _ = self._fns.popitem(last=False)
            self.stats.evictions += 1
            self._key_record(old_key)["evictions"] += 1

    def put(self, key: tuple, fn: Callable, build_s: float) -> None:
        with self._lock:
            self._fns[key] = fn
            self._evict_over_capacity()
            self.stats.misses += 1
            self.stats.size = len(self._fns)
            self.stats.build_time_s += build_s
            rec = self._key_record(key)
            rec["misses"] += 1
            rec["build_time_s"] += build_s

    def get_or_create(self, key: tuple, builder: Callable[[], Callable],
                      extra_build_s: float = 0.0) -> Callable:
        """Hit, or build exactly once under concurrency: the first thread
        to miss a key runs ``builder`` (outside the lock) while racing
        threads block on an in-flight event and then share the result.  A
        build that raises is not cached: the next call builds again."""
        while True:
            with self._lock:
                fn = self._fns.get(key)
                if fn is not None:
                    self._fns.move_to_end(key)
                    self.stats.hits += 1
                    self._key_record(key)["hits"] += 1
                    return fn
                ev = self._pending.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._pending[key] = ev
                    break                      # we own the build
            ev.wait()                          # another thread is building
        t0 = time.perf_counter()
        try:
            fn = builder()
            self.put(key, fn, time.perf_counter() - t0 + extra_build_s)
            return fn
        finally:
            with self._lock:
                self._pending.pop(key, None)
            ev.set()

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self._key_stats.clear()
            self.stats = WholePlanCacheStats(capacity=self.maxsize)


WHOLE_PLAN_CACHE = WholePlanCache()


def whole_plan_cache_stats() -> WholePlanCacheStats:
    """Snapshot of the whole-plan cache counters: ``hits``, ``misses``,
    ``size``, ``capacity``, ``evictions``, ``build_time_s`` and
    ``tracked_keys`` / ``dropped_keys`` (per-key stat records alive / aged
    out — see :meth:`WholePlanCache.key_stats`)."""
    with WHOLE_PLAN_CACHE._lock:
        return replace(WHOLE_PLAN_CACHE.stats,
                       size=len(WHOLE_PLAN_CACHE._fns),
                       capacity=WHOLE_PLAN_CACHE.maxsize,
                       tracked_keys=len(WHOLE_PLAN_CACHE._key_stats))


# --------------------------------------------------------------------------
# generated operators
# --------------------------------------------------------------------------

@dataclass
class GeneratedOp:
    """A fused operator (SystemML's SpoofOp): its CPlan; the CUDA kernel is
    generated and built on its first launch (:mod:`repro_torch.kernels`)."""
    cplan: CPlan


def _eval_basic(graph: Graph, node: Node, env: dict, lits: dict):
    """Basic (unfused) operator, sparse-format aware; a plain large product
    stays ``torch.matmul``.  A BCSR left matmul operand runs the block
    product (``ta``: over ``BCSR.T``, exact and O(nnz), never densified), a
    BCSR times a dense operand of its shape stays BCSR; anything else
    (a DictCompressed operand included) is densified.  Dense results are
    contiguous (kernel operands); over batched (B, r, c) values the op is
    the batched torch op."""
    ins = [lits[i.nid] if i.op == "lit" else env[i.nid]
           for i in node.inputs]
    if node.is_matmul and isinstance(ins[0], BCSR):
        b = kops._as_dense(ins[1])
        b = b.T if node.tb else b
        a = ins[0].T if node.ta else ins[0]
        return kops.bcsr_matmul(a, b.contiguous())
    if node.op == "mul" and isinstance(ins[0], BCSR) \
            and isinstance(ins[1], torch.Tensor) \
            and tuple(ins[1].shape) == ins[0].shape:
        return kops.bcsr_mul_dense(ins[0], ins[1])
    ins = [kops._as_dense(v) for v in ins]
    return kref.eval_node(node.op, ins, node.attrs).contiguous()


# --------------------------------------------------------------------------
# executable plans
# --------------------------------------------------------------------------

def _spec_roots(spec) -> tuple[int, ...]:
    return tuple(spec.roots) if isinstance(spec, MultiAggSpec) \
        else (spec.root,)


@dataclass
class CompiledPlan:
    """Executable form of an ExecPlan: the staged plan function.

    Fused operators, basic ops, literals and multi-aggregate unpacking run
    in plan order in one Python function; intermediates are released at
    their last use (``_last_uses``); inputs are never donated, so
    re-calling with the same tensors is always valid.  Staged functions
    (and their batched forms) are shared across structurally-equal plans
    via the :class:`WholePlanCache`.  ``staged=False`` runs
    :meth:`_call_per_op` instead."""
    plan: ExecPlan
    kernels: str = "never"
    device: str = "cpu"
    staged: bool = True
    cache: PlanCache = field(default_factory=lambda: PLAN_CACHE)
    #: staged plan function (positional inputs, ``graph.inputs()`` order)
    _staged_fn: Optional[Callable] = field(default=None, repr=False)
    #: structural whole-plan cache key of the staged lowering
    _staged_key: Optional[tuple] = field(default=None, repr=False)
    #: (1,1) literal tensors of the per-op path, built once
    _lit_cache: Optional[dict] = field(default=None, repr=False)

    def staged_callable(self) -> Callable:
        if self._staged_fn is None:
            self._staged_fn = self._build_staged()
        return self._staged_fn

    def cplans(self) -> list[CPlan]:
        """The CPlan of every fused operator, in plan order."""
        g = self.plan.graph
        return [self.cache.get_or_build(g, s)[1] for s in self.plan.specs
                if isinstance(s, MultiAggSpec)
                or (isinstance(s, FusedOpSpec) and s.fused)]

    def _steps(self) -> tuple:
        """(input nids, output nids, steps, dead values per step): the
        plan's executable steps, shared by the staged and batched
        lowerings."""
        graph, plan = self.plan.graph, self.plan
        in_nids = tuple(n.nid for n in graph.inputs())
        output_ids = tuple(o.nid for o in graph.outputs)
        steps: list[tuple] = []
        for spec in plan.specs:
            if isinstance(spec, MultiAggSpec) or (
                    isinstance(spec, FusedOpSpec) and spec.fused):
                _op, cplan = self.cache.get_or_build(graph, spec)
                steps.append(("fused", cplan,
                              tuple(b.nid for b in cplan.binds),
                              _spec_roots(spec)))
            else:
                steps.append(("basic", graph.by_id[spec.root]))
        keep = set(output_ids)
        free = {idx: [d for d in dead if d not in keep]
                for idx, dead in _last_uses(plan).items()}
        return in_nids, output_ids, steps, free

    def _literals(self) -> dict[int, torch.Tensor]:
        """(1,1) fp32 literal tensors on the plan's device, built once."""
        if self._lit_cache is None:
            self._lit_cache = {
                n.nid: torch.full((1, 1), float(n.attrs["value"]),
                                  dtype=torch.float32, device=self.device)
                for n in self.plan.graph.nodes if n.op == "lit"}
        return self._lit_cache

    def _plan_fn(self, batched: bool) -> Callable:
        graph = self.plan.graph
        in_nids, output_ids, steps, free = self._steps()
        kernels = self.kernels
        lits = self._literals()
        run = kops.execute_batched if batched else kops.execute
        aligned = _stack_aligned if batched else (lambda v: v)

        def plan_fn(*arrays):
            env: dict[int, object] = {nid: aligned(a)
                                      for nid, a in zip(in_nids, arrays)}
            env.update(lits)
            for step_idx, step in enumerate(steps):
                if step[0] == "fused":
                    _, cplan, bind_nids, roots = step
                    out = run(cplan, {nid: env[nid] for nid in bind_nids},
                              kernels=kernels)
                    if len(roots) > 1:
                        for k, r in enumerate(roots):
                            env[r] = out[..., k:k + 1, :] if batched \
                                else out[k].reshape(1, 1)
                    else:
                        env[roots[0]] = out
                else:
                    node = step[1]
                    env[node.nid] = aligned(
                        _eval_basic(graph, node, env, lits))
                for dead in free.get(step_idx, ()):
                    env.pop(dead, None)      # release the intermediate
            return tuple(env[o] for o in output_ids)

        return plan_fn

    def _build_staged(self) -> Callable:
        t0 = time.perf_counter()
        plan_fn = self._plan_fn(batched=False)
        key = (staged_plan_key(self.plan, kernels=self.kernels,
                               cache=self.cache), self.device)
        self._staged_key = key

        def _build():
            faults.fault_point("plan.build")
            return plan_fn

        return WHOLE_PLAN_CACHE.get_or_create(
            key, _build, extra_build_s=time.perf_counter() - t0)

    def batched_callable(self) -> Callable:
        """The staged plan function over a leading request axis — the
        counterpart of the reference's ``jit(vmap(plan_fn))``, and what
        the fused-plan server (:mod:`repro_torch.serve.fusion`) dispatches
        one *batch* of same-structure requests through.  Takes each graph
        input stacked to ``(B, *shape)`` (``graph.inputs()`` order) and
        returns every output stacked the same way; requests are computed
        independently, so the result equals B separate calls.  Each fused
        step is one call of its kernel's request-axis form for the whole
        batch (:func:`~repro_torch.kernels.ops.execute_batched`).  Under
        ``kernels="cuda"`` on the card the build generates and compiles
        every fused step's kernel, so a program no kernel can run fails
        here, at build time.  Shared across structurally-equal plans via
        the whole-plan cache (key ``("batched", staged key)``)."""
        self.staged_callable()
        key = ("batched", self._staged_key)
        plan_fn = self._plan_fn(batched=True)

        def _build():
            faults.fault_point("plan.build")
            if self.kernels != "never" and \
                    torch.device(self.device).type == "cuda":
                from repro_torch.kernels import build, cuda_src
                build.build_all([cuda_src.source_for(cp)
                                 for cp in self.cplans()
                                 if cp.ttype != TType.OUTER])
            return plan_fn

        return WHOLE_PLAN_CACHE.get_or_create(key, _build)

    def _call_per_op(self, bindings: dict[str, object]):
        """Per-operator dispatch without the whole-plan cache: each fused
        operator through the operator-level plan cache (positionally
        re-bound to the cached operator's CPlan), each basic op on its
        own, under the same ``kernels`` policy."""
        graph = self.plan.graph
        env: dict[int, object] = {node.nid: bindings[node.name]
                                  for node in graph.inputs()}
        lits = self._literals()
        env.update(lits)
        last_use = _last_uses(self.plan)
        for idx, spec in enumerate(self.plan.specs):
            if isinstance(spec, MultiAggSpec) or (
                    isinstance(spec, FusedOpSpec) and spec.fused):
                op, my_cplan = self.cache.get_or_build(graph, spec)
                # positional re-binding: the cached operator's nids ≠ ours
                op_env = {ob.nid: env[mb.nid] for ob, mb in
                          zip(op.cplan.binds, my_cplan.binds)}
                out = kops.execute(op.cplan, op_env, kernels=self.kernels)
                if isinstance(spec, MultiAggSpec):
                    for k, r in enumerate(spec.roots):
                        env[r] = out[k].reshape(1, 1)
                else:
                    env[spec.root] = out
            else:
                env[spec.root] = _eval_basic(graph, graph.by_id[spec.root],
                                             env, lits)
            for dead in last_use.get(idx, ()):    # free intermediates
                if dead not in graph.output_ids:
                    env.pop(dead, None)
        outs = [env[o.nid] for o in graph.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def __call__(self, bindings: dict[str, object]):
        graph = self.plan.graph
        for node in graph.inputs():
            if node.name not in bindings:
                raise KeyError(f"missing binding for input '{node.name}'")
        if not self.staged:
            return self._call_per_op(bindings)
        fn = self.staged_callable()
        outs = fn(*[bindings[n.name] for n in graph.inputs()])
        return outs[0] if len(outs) == 1 else tuple(outs)


def _stack_aligned(v):
    """A batched value (B, r, c) on the card as the request-axis kernels
    take it: each request's slice contiguous and starting on a 16-byte
    boundary (the Cell kernel's vector walk reads float4) — copied into a
    padded stack (:func:`~repro_torch.kernels.build.batch_empty`) when it
    is not.  CPU values and 2-D (shared) values pass as they are."""
    if not isinstance(v, torch.Tensor) or v.dim() != 3 \
            or v.device.type != "cuda":
        return v
    from repro_torch.kernels import build
    if build.batch_aligned(v):
        return v
    out = build.batch_empty(v.shape[0], tuple(v.shape[1:]), v.device)
    out.copy_(v)
    return out


def _last_uses(plan: ExecPlan) -> dict[int, list[int]]:
    last: dict[int, int] = {}
    for idx, spec in enumerate(plan.specs):
        for i in spec.inputs:
            last[i] = idx
    out: dict[int, list[int]] = {}
    for nid, idx in last.items():
        out.setdefault(idx, []).append(nid)
    return out


def staged_plan_key(plan: ExecPlan, kernels: str = "never",
                    cache: Optional[PlanCache] = None) -> tuple:
    """The structural whole-plan cache key of the staged lowering,
    computed without running anything — the replay the plan verifier's
    key-completeness check (EXE004) runs: every value a step consumes must
    resolve to a canonical env token, so a ``KeyError`` here means the
    plan wires a value no step produces."""
    cache = cache if cache is not None else PLAN_CACHE
    graph = plan.graph
    in_nids = tuple(n.nid for n in graph.inputs())
    output_ids = tuple(o.nid for o in graph.outputs)
    canon: dict[int, tuple] = {nid: ("in", p)
                               for p, nid in enumerate(in_nids)}
    for n in graph.nodes:
        if n.op == "lit":
            canon[n.nid] = ("lit", float(n.attrs["value"]))

    key_parts: list[tuple] = []
    for spec in plan.specs:
        step_idx = len(key_parts)
        if isinstance(spec, MultiAggSpec) or (
                isinstance(spec, FusedOpSpec) and spec.fused):
            _op, cplan = cache.get_or_build(graph, spec)
            bind_nids = tuple(b.nid for b in cplan.binds)
            key_parts.append(("fused", cplan.cache_key(),
                              tuple(canon[nid] for nid in bind_nids)))
            for k, r in enumerate(_spec_roots(spec)):
                canon[r] = ("s", step_idx, 0, k)
        else:
            node = graph.by_id[spec.root]
            key_parts.append((
                "basic", node.op,
                tuple(sorted(node.attrs.items())), node.shape,
                tuple(canon[i.nid] if i.op != "lit"
                      else ("lit", float(i.attrs["value"]))
                      for i in node.inputs)))
            canon[spec.root] = ("s", step_idx, 0, 0)
    return (tuple(key_parts), tuple(canon[o] for o in output_ids), kernels,
            tuple(getattr(plan, "rewrite", ()) or ()))


def plan_fallbacks(plan: ExecPlan, layout=None, kernels: str = "never",
                   staged: bool = True,
                   cache: Optional[PlanCache] = None) -> list:
    """Statically derivable execution downgrades: on one device (the port
    accepts no layout yet) only the per-operator dispatch asked for with
    ``staged=False``."""
    from .context import require_local
    require_local(layout)
    if not staged:
        return [{"site": "plan",
                 "reason": "staged=False: per-operator debug dispatch "
                           "requested"}]
    return []


def freed_intermediates(plan: ExecPlan) -> int:
    """Number of intermediate values the staged function releases at
    their last use (graph outputs excepted)."""
    outs = set(plan.graph.output_ids)
    return sum(1 for dead in _last_uses(plan).values()
               for d in dead if d not in outs)


def compile_plan(plan: ExecPlan, kernels: str = "never",
                 device: str = "cpu", staged: bool = True) -> CompiledPlan:
    """Bind an ExecPlan to its executable form on ``device``: the staged
    plan function, or per-operator dispatch with ``staged=False``."""
    return CompiledPlan(plan, kernels=kernels, device=device, staged=staged)
