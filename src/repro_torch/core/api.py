"""Public fusion API: the staged ``trace → plan → compile`` pipeline.

The paper's three optimizer phases (candidate exploration, cost-based
selection, code generation) are explicit, inspectable stages:

    hinge = fused(lambda X, w, y: ir.relu(1 - y * (X @ w)))

    traced   = hinge.trace(X, w, y)                # IR graph, static shapes
    planned  = traced.plan(mode="gen")             # explore → select
    print(planned.explain())                       # per-candidate cost report
    op       = planned.compile(kernels="cuda")     # generated fused operators
    out      = op(X, w, y)

``@fused`` call syntax stays as sugar over the staged path: the wrapper
traces/plans/compiles on first call per (shape, context) signature and
memoizes the Compiled stage.

**Autodiff.**  Every call runs through a ``torch.autograd.Function`` whose
backward is *itself* planned through explore → select
(:mod:`repro_torch.core.grad`), so ``torch.autograd.grad`` of a ``@fused``
region executes generated fused operators in both directions.

**Devices.**  Operands (numpy arrays, tensors, python scalars) are placed
on the context's device — the card unless the context says
``device="cpu"``; asking for the card without one raises.

Operands may be 2-D matrices (dense, block-sparse
:class:`~repro_torch.kernels.blocksparse.BCSR`, or CLA-compressed
:class:`~repro_torch.kernels.blocksparse.DictCompressed`), 1-D vectors, or
0-D scalars; non-2-D inputs
are canonicalized to column / 1×1 matrices for planning.  **Round-trip
rule:** when a call passes any 1-D/0-D operand, outputs of shape ``(n, 1)``
are returned as 1-D ``(n,)`` and ``(1, 1)`` outputs as 0-D scalars; calls
made entirely with 2-D operands always return 2-D results.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.interop import resolve_device
from repro_torch.kernels.blocksparse import BCSR, DictCompressed
from . import ir
from .codegen import (CompiledPlan, compile_plan, freed_intermediates,
                      plan_fallbacks, staged_plan_key)
from .context import FusionContext, current_context, require_local
from .cost import CostParams
from .grad import vjp_graph
from .select import ExecPlan, MODES, MultiAggSpec, plan as plan_graph
from .verify import VerifyReport, verify_exec, verify_plan


class FusionInputError(TypeError):
    """An operand cannot be lifted into the 2-D LinOp IR."""


# --------------------------------------------------------------------------
# operand canonicalization (1-D vectors / 0-D scalars → column / 1×1)
# --------------------------------------------------------------------------

def _canon_shape(name: str, v) -> tuple[tuple[int, int], int]:
    """(canonical 2-D shape, original ndim) of one operand: a 1-D vector
    of length n plans as an (n, 1) column, a 0-D / python scalar as
    (1, 1); ranks above 2 raise :class:`FusionInputError`."""
    if isinstance(v, (BCSR, DictCompressed)):
        return tuple(v.shape), 2
    if isinstance(v, (int, float)):
        return (1, 1), 0
    if not hasattr(v, "shape"):
        raise FusionInputError(
            f"argument '{name}': expected an array, matrix, or scalar, "
            f"got {type(v).__name__}")
    shape = tuple(int(d) for d in v.shape)
    if len(shape) == 2:
        return shape, 2
    if len(shape) == 1:
        return (shape[0], 1), 1           # column-vector convention
    if len(shape) == 0:
        return (1, 1), 0
    raise FusionInputError(
        f"argument '{name}': expected 0-D, 1-D or 2-D, got shape {shape}")


def _canon_value(name: str, v, device: torch.device):
    """The operand as a contiguous fp32 (2-D) tensor on ``device``;
    tensors keep their autograd history.  A BCSR or DictCompressed moves
    to ``device`` and stays compressed."""
    if isinstance(v, (BCSR, DictCompressed)):
        return v.to(device)
    shape, _nd = _canon_shape(name, v)
    if isinstance(v, torch.Tensor):
        t = v.to(device=device, dtype=torch.float32)
    else:
        t = torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
    return t.reshape(shape).contiguous()


def _uncanon_output(out):
    """(n, 1) columns → 1-D ``(n,)``, (1, 1) → 0-D (vector-world calls)."""
    shape = tuple(out.shape)
    if shape == (1, 1):
        return out.reshape(())
    if len(shape) == 2 and shape[1] == 1:
        return out.reshape(shape[0])
    return out


def _as_expr_inputs(args: dict[str, object],
                    sparsity: dict[str, float]) -> dict[str, ir.Expr]:
    """IR inputs; a BCSR operand's sparsity defaults to its block
    sparsity."""
    return {name: ir.matrix(name, _canon_shape(name, v)[0],
                            sparsity=sparsity.get(
                                name, v.block_sparsity
                                if isinstance(v, BCSR) else 1.0))
            for name, v in args.items()}


def _signature(args: dict[str, object], ctx: FusionContext):
    sig: list = [ctx.key()]
    for name, v in args.items():
        if isinstance(v, BCSR):
            sig.append((name, "bcsr", v.shape, v.bs,
                        round(v.block_sparsity, 4)))
        elif isinstance(v, DictCompressed):
            sig.append((name, "dict", v.shape))
        else:
            shape, nd = _canon_shape(name, v)
            sig.append((name, "dense", shape, nd))
    return tuple(sig)


# --------------------------------------------------------------------------
# stage 1: Traced — the IR graph of the expression at static shapes
# --------------------------------------------------------------------------

@dataclass
class Traced:
    """Abstract trace of an expression function: the HOP DAG plus operand
    metadata.  Planning-only — carries no array data."""

    name: str
    graph: ir.Graph
    in_names: list[str]                    # fn-signature order
    in_meta: dict[str, dict]               # name → {shape, format, sparsity}

    def plan(self, mode: Optional[str] = None,
             params: Optional[CostParams] = None,
             layout=None,
             context: Optional[FusionContext] = None) -> "Planned":
        """Stage 2: run explore → select, returning a :class:`Planned`.

        ``mode`` (``"gen"`` | ``"fa"`` | ``"fnr"`` | ``"none"``) and
        ``params`` override the scoped :class:`FusionContext` (or
        ``context``); ``layout`` must be None (one device)."""
        require_local(layout)
        ctx = context if context is not None else current_context()
        require_local(ctx.layout)
        if mode is not None:
            ctx = ctx.with_(mode=mode)
        if params is not None:
            ctx = ctx.with_(params=params)
        eplan = plan_graph(self.graph, ctx.mode, ctx.params)
        rw_report = None
        if ctx.rewrite:
            eplan, rw_report = _rewrite_sweep(self.graph, ctx, eplan)
        planned = _verified_planned(self, ctx, eplan)
        planned._rewrite = rw_report
        return planned


# --------------------------------------------------------------------------
# stage 2: Planned — a selected ExecPlan with costs and an explain() report
# --------------------------------------------------------------------------

def _rewrite_sweep(graph: ir.Graph, ctx: FusionContext,
                   base: ExecPlan) -> tuple[ExecPlan, dict]:
    """The SPORES-style variant sweep between trace and plan: generate
    algebraically-equal DAG variants (:mod:`repro_torch.core.rewrite`),
    gate each through the rewrite verifier (RW001–RW004, at least
    ``"cheap"``), plan the clean ones, and return the global cost argmin
    plus the ``explain()["rewrite"]`` report.  Deterministic: ties break
    toward the earlier variant and the original DAG."""
    from .rewrite import rewrite_variants
    from .verify import verify_variant

    level = "strict" if ctx.verify == "strict" else "cheap"
    variants = rewrite_variants(graph)
    entries = [{"rules": [], "cost": base.cost, "selected": False}]
    rejected: list[dict] = []
    best, best_idx, best_rules = base, 0, ()
    for v in variants:
        vrep = verify_variant(graph, v.graph, level=level)
        if not vrep.ok:
            rejected.append({"rules": list(v.rules),
                             "errors": sorted({d.code
                                               for d in vrep.errors})})
            continue
        ep = plan_graph(v.graph, ctx.mode, ctx.params)
        entries.append({"rules": list(v.rules), "cost": ep.cost,
                        "selected": False})
        if ep.cost < best.cost:
            best, best_idx, best_rules = ep, len(entries) - 1, v.rules
    entries[best_idx]["selected"] = True
    best.rewrite = tuple(best_rules)
    report = {
        "enabled": True,
        "n_variants": len(variants),
        "n_planned": len(entries) - 1,
        "n_rejected": len(rejected),
        "rejected": rejected,
        "variants": entries,
        "winner": {
            "rules": list(best_rules),
            "cost": best.cost,
            "baseline_cost": base.cost,
            "improvement": base.cost - best.cost,
        },
    }
    return best, report


def _verified_planned(traced: Traced, ctx: FusionContext,
                      eplan: ExecPlan) -> "Planned":
    """The plan() stage boundary: every ExecPlan entering stage 2 passes
    the plan verifier at the context's level; error diagnostics raise
    :class:`~repro_torch.core.verify.VerificationError` here."""
    planned = Planned(traced, ctx, eplan)
    if ctx.verify != "off":
        report = verify_plan(eplan, level=ctx.verify, kernels=ctx.kernels)
        report.raise_if_errors()
        planned._verify = report
    return planned


def _spec_signature(graph: ir.Graph, spec) -> dict:
    def label(nid: int) -> str:
        n = graph.by_id[nid]
        return n.name if n.name else n.op

    if isinstance(spec, MultiAggSpec):
        return {"template": "MAGG(multi)",
                "root": [graph.by_id[r].op for r in spec.roots],
                "inputs": sorted(label(i) for i in spec.inputs),
                "driver": None,
                "n_covered": sum(len(p.cover) for p in spec.parts)}
    return {"template": spec.ttype.name if spec.ttype is not None else "basic",
            "root": graph.by_id[spec.root].op,
            "inputs": sorted(label(i) for i in spec.inputs),
            "driver": label(spec.driver) if spec.driver is not None else None,
            "n_covered": len(spec.cover)}


@dataclass
class Planned:
    """One selected execution plan for a Traced expression."""

    traced: Traced
    context: FusionContext
    eplan: ExecPlan
    _bwd: Optional["Planned"] = field(default=None, repr=False)
    #: VerifyReport from the plan() stage boundary (None: verify="off")
    _verify: Optional[VerifyReport] = field(default=None, repr=False)
    #: rewrite-sweep report from Traced.plan() (None: not swept)
    _rewrite: Optional[dict] = field(default=None, repr=False)

    @property
    def cost(self) -> float:
        return self.eplan.cost

    def fused_signatures(self) -> list[dict]:
        """Structural signature of every selected fused operator."""
        return [_spec_signature(self.eplan.graph, s)
                for s in self.eplan.fused_specs()]

    def candidates(self) -> list[dict]:
        """Cost every selection arm on this plan's graph (the winning
        rewrite variant's, when the sweep won)."""
        out = []
        for m in MODES:
            p = self.eplan if m == self.context.mode \
                else plan_graph(self.eplan.graph, m, self.context.params)
            out.append({"mode": m, "cost": p.cost,
                        "n_fused": len(p.fused_specs()),
                        "n_operators": len(p.specs),
                        "selected": m == self.context.mode})
        return out

    def backward(self) -> "Planned":
        """Plan the gradient DAG through the same explore → select pipeline
        (fused backward operators).  Raises NonDifferentiableError when the
        forward graph has an op with no VJP rule."""
        if self._bwd is None:
            ct_names, grads = vjp_graph(self.eplan.graph)
            fwd_inputs = [n.name for n in self.eplan.graph.inputs()]
            bgraph = ir.Graph.build([grads[n] for n in fwd_inputs])
            in_meta = dict(self.traced.in_meta)
            for name, o in zip(ct_names, self.eplan.graph.outputs):
                in_meta[name] = {"shape": o.shape, "format": "dense",
                                 "sparsity": 1.0}
            btr = Traced(self.traced.name + ":vjp", bgraph,
                         list(self.traced.in_names) + ct_names, in_meta)
            self._bwd = _verified_planned(
                btr, self.context,
                plan_graph(bgraph, self.context.mode, self.context.params))
            self._bwd.grad_names = fwd_inputs   # type: ignore[attr-defined]
        return self._bwd

    def explain(self, include_backward: bool = False) -> dict:
        """Structured plan report: ``expression``, ``mode``, ``inputs``,
        ``winner`` (cost, operator count, one signature per fused
        operator), ``candidates`` (every selection arm), ``rewrite`` (the
        variant sweep, ``{"enabled": False}`` when off), ``stats``
        (exploration/enumeration counters), ``execution`` (kernel policy,
        device, freed intermediates, never-donated inputs, fallbacks),
        ``verify`` (the plan verifier's report) and, with
        ``include_backward=True``, the planned gradient DAG's report."""
        ex, en = self.eplan.explore_stats, self.eplan.enum_stats
        report = {
            "expression": self.traced.name,
            "mode": self.context.mode,
            "inputs": {n: {"shape": list(m["shape"]),
                           "format": m["format"],
                           "sparsity": round(float(m["sparsity"]), 4)}
                       for n, m in self.traced.in_meta.items()},
            "winner": {
                "cost": self.eplan.cost,
                "n_operators": len(self.eplan.specs),
                "operators": self.fused_signatures(),
            },
            "candidates": self.candidates(),
            "rewrite": (self._rewrite if self._rewrite is not None
                        else {"enabled": False}),
            "stats": {
                "explored_operators": ex.operators if ex else 0,
                "memo_entries": ex.entries_kept if ex else 0,
                "partitions": en.partitions if en else 0,
                "enum_points": en.points_total if en else 0,
                "plans_costed": en.plans_costed if en else 0,
            },
            "execution": {
                "kernels": self.context.kernels,
                "device": self.context.device,
                "donated_inputs": [],       # inputs are never donated
                "freed_intermediates": freed_intermediates(self.eplan),
                "fallbacks": plan_fallbacks(self.eplan,
                                            kernels=self.context.kernels,
                                            staged=self.context.staged),
            },
            "layout": None,
        }
        if self._verify is None and self.context.verify != "off":
            self._verify = verify_plan(self.eplan,
                                       level=self.context.verify,
                                       kernels=self.context.kernels)
        report["verify"] = (self._verify.summary()
                            if self._verify is not None else None)
        if include_backward:
            bwd = self.backward()
            report["backward"] = {
                "cost": bwd.cost,
                "n_operators": len(bwd.eplan.specs),
                "operators": bwd.fused_signatures(),
            }
        return report

    def compile(self, kernels: Optional[str] = None,
                device: Optional[str] = None,
                staged: Optional[bool] = None) -> "Compiled":
        """Stage 3: bind the plan to generated operators.

        ``kernels`` (``"cuda"`` | ``"never"``), ``device`` and ``staged``
        override the context: ``staged=True`` (default) runs the staged
        plan function, shared across structurally-equal plans through the
        whole-plan cache; ``staged=False`` dispatches per operator (the
        serving ladder's bottom tier).  The returned :class:`Compiled` is
        callable on arrays and differentiable (a
        ``torch.autograd.Function`` whose backward is the *planned*
        gradient DAG)."""
        ctx = self.context
        if kernels is not None:
            ctx = ctx.with_(kernels=kernels)
        if device is not None:
            ctx = ctx.with_(device=device)
        if staged is not None:
            ctx = ctx.with_(staged=staged)
        if ctx.verify != "off":
            # the compile() stage boundary re-checks the execution-level
            # invariants (liveness, aliasing, whole-plan key)
            report = VerifyReport(level=ctx.verify)
            report.diagnostics.extend(verify_exec(
                self.eplan, strict=ctx.verify == "strict",
                kernels=ctx.kernels))
            report.raise_if_errors()
        return Compiled(replace(self, context=ctx))


# --------------------------------------------------------------------------
# stage 3: Compiled — an executable, differentiable fused operator
# --------------------------------------------------------------------------

class _PlannedFunction(torch.autograd.Function):
    """Forward: the staged plan function.  Backward: the planned gradient
    DAG (``Planned.backward()``), cotangents cast to fp32, zeros for the
    inputs the gradient DAG does not reach."""

    @staticmethod
    def forward(ctx, compiled: "Compiled", *arrs):
        ctx.compiled = compiled
        ctx.save_for_backward(*arrs)
        return compiled._run_plain(arrs)

    @staticmethod
    def backward(ctx, *cts):
        compiled = ctx.compiled
        arrs = ctx.saved_tensors
        names = compiled.planned.traced.in_names
        bwd_plan, grad_names, ct_names = compiled._get_bwd()
        binds = dict(zip(names, arrs))
        binds.update({n: c.to(torch.float32).contiguous()
                      for n, c in zip(ct_names, cts)})
        grads = bwd_plan(binds)
        if not isinstance(grads, tuple):
            grads = (grads,)
        by_name = dict(zip(grad_names, grads))
        return (None,) + tuple(
            by_name[n] if n in by_name else torch.zeros_like(arrs[i])
            for i, n in enumerate(names))


class Compiled:
    """Executable fused operator: runs the CompiledPlan on the context's
    device through a ``torch.autograd.Function`` whose backward pass is
    the planned gradient DAG."""

    def __init__(self, planned: Planned):
        self.planned = planned
        ctx = planned.context
        self.device = resolve_device(ctx.device)
        self._cplan: CompiledPlan = compile_plan(
            planned.eplan, kernels=ctx.kernels, device=str(self.device),
            staged=ctx.staged)
        self._bwd_compiled: Optional[CompiledPlan] = None

    # -- serving hooks ------------------------------------------------------
    @property
    def input_order(self) -> list[str]:
        """Operand names in the staged function's positional order
        (``graph.inputs()`` order — may differ from the expression
        function's signature order)."""
        return [n.name for n in self.planned.eplan.graph.inputs()]

    def plan_key(self) -> tuple:
        """Structural whole-plan signature of this compiled plan (the
        staged cache key).  Two Compiled objects with equal plan keys share
        one staged function — the bucketing identity the fused-plan server
        (:mod:`repro_torch.serve.fusion`) batches concurrent requests by."""
        return staged_plan_key(self.planned.eplan,
                               kernels=self.planned.context.kernels)

    def batched(self):
        """The staged plan function over a leading request axis: takes
        each input stacked to ``(B, *shape)`` in :attr:`input_order` and
        returns the output tuple stacked the same way (requests
        independent); each fused operator is one launch of its kernel's
        request-axis form for the whole batch.  Dense plans only; shared
        across structurally-equal plans via the whole-plan cache."""
        return self._cplan.batched_callable()

    # -- execution ----------------------------------------------------------
    def _run_plain(self, arrs):
        return self._cplan(dict(zip(self.planned.traced.in_names, arrs)))

    def _get_bwd(self) -> tuple[CompiledPlan, list[str], list[str]]:
        bwd = self.planned.backward()
        if self._bwd_compiled is None:
            self._bwd_compiled = compile_plan(
                bwd.eplan, kernels=self.planned.context.kernels,
                device=str(self.device), staged=self.planned.context.staged)
        ct_names = [n for n in bwd.traced.in_names if n.startswith("__ct")]
        return self._bwd_compiled, bwd.grad_names, ct_names  # type: ignore

    def explain(self, include_backward: bool = False) -> dict:
        return self.planned.explain(include_backward=include_backward)

    def _bind(self, args, kwargs) -> dict:
        bound = dict(zip(self.planned.traced.in_names, args))
        bound.update(kwargs)
        return bound

    def __call__(self, *args, **kwargs):
        """Execute on concrete operands (positional or by name).  Dense
        calls run through the ``torch.autograd.Function``; a call with any
        BCSR or DictCompressed operand takes the direct forward-only
        dispatch.  Any 1-D/0-D
        operand puts the call in "vector world": outputs round-trip back
        through :func:`_uncanon_output`."""
        bound = self._bind(args, kwargs)
        vector_world = any(
            _canon_shape(n, v)[1] < 2 for n, v in bound.items())
        names = self.planned.traced.in_names
        arrs = [_canon_value(n, bound[n], self.device) for n in names]
        if any(isinstance(a, (BCSR, DictCompressed)) for a in arrs):
            outs = self._run_plain(arrs)
        else:
            outs = _PlannedFunction.apply(self, *arrs)
        if vector_world:
            if isinstance(outs, tuple):
                return tuple(_uncanon_output(o) for o in outs)
            return _uncanon_output(outs)
        return outs


# --------------------------------------------------------------------------
# the @fused wrapper — sugar over trace → plan → compile
# --------------------------------------------------------------------------

class Fused:
    """Callable wrapper staging an expression function on demand.

    Each distinct (shape, context) signature is traced, planned, and
    compiled once; subsequent calls reuse the Compiled stage (and,
    transitively, the structural plan cache)."""

    def __init__(self, fn: Callable, sparsity: Optional[dict] = None):
        self.fn = fn
        self.sparsity = dict(sparsity or {})
        self.names = list(inspect.signature(fn).parameters)
        self._staged: dict[tuple, Compiled] = {}

    def trace(self, *args, **kwargs) -> Traced:
        """Stage 1: trace with abstract or concrete operands (anything with
        ``.shape`` — arrays, tensors, BCSR — or python scalars)."""
        bound = dict(zip(self.names, args))
        bound.update(kwargs)
        exprs = _as_expr_inputs(bound, self.sparsity)
        outs = self.fn(**exprs)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        graph = ir.Graph.build(list(outs))
        meta = {name: {"shape": _canon_shape(name, v)[0],
                       "format": ("bcsr" if isinstance(v, BCSR) else
                                  "dict" if isinstance(v, DictCompressed)
                                  else "dense"),
                       "sparsity": exprs[name].node.sparsity}
                for name, v in bound.items()}
        return Traced(getattr(self.fn, "__name__", "<expr>"), graph,
                      list(bound), meta)

    def plan_for(self, **shaped_args) -> ExecPlan:
        """Trace + plan under the current context (inspection helper)."""
        return self.trace(**shaped_args).plan().eplan

    def __call__(self, *args, **kwargs):
        ctx = current_context()
        bound = dict(zip(self.names, args))
        bound.update(kwargs)
        key = _signature(bound, ctx)
        compiled = self._staged.get(key)
        if compiled is None:
            compiled = self.trace(**bound).plan(context=ctx).compile()
            self._staged[key] = compiled
        return compiled(**bound)


def fused(fn: Optional[Callable] = None, *, sparsity: Optional[dict] = None):
    """Wrap an expression function as a stageable fused region.

    ``fn`` is a python function over :mod:`repro_torch.core.ir`
    expressions.  The returned :class:`Fused` wrapper offers the staged
    spelling (``f.trace(*operands).plan(...).compile(...)``) and call sugar
    (``f(*arrays)``, memoized per (shape, context) signature).  Usable bare
    (``@fused``) or with arguments (``@fused(sparsity={"X": 0.05})``)."""
    if fn is None:
        return lambda f: Fused(f, sparsity=sparsity)
    return Fused(fn, sparsity=sparsity)
