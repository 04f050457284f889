"""Plan verifier: static analysis over HOP DAGs, CPlans, and ExecPlans.

The paper's pitch is that candidate exploration only emits *valid* fusion
plans and that cost-based selection preserves semantics — this module is
where those claims become machine-checked invariants instead of implicit
properties of the construction code.  Three checkers share one diagnostic
framework:

* :func:`verify_graph` — the **IR verifier** over the traced HOP DAG:
  acyclicity / topological order, single-producer SSA form, shape
  inference re-derived bottom-up (:func:`repro_torch.core.ir.infer_shape`) and
  cross-checked against stored metadata, dtype consistency, and the
  operand-canonicalization invariants (strict 2-D shapes, (1,1) literals,
  named inputs, valid aggregation axes).
* :func:`verify_selection` — the **CPlan/selection verifier**: cover
  connectivity and input-boundary consistency, template applicability
  (Cell/Row/MAgg/Outer root qualification and interior compatibility),
  sparsity-exploitation safety (the driver chain must be zero-preserving
  over the exploited input), production/dependency order, placement
  epilogues against :data:`repro_torch.core.templates.DIST_VARIANTS`, shard
  divisibility, and every :class:`~repro_torch.core.select.Segment`'s
  row-partitioned data flow.
* :func:`verify_exec` — the **ExecPlan/codegen verifier**:
  ``_last_uses`` liveness soundness (no operator reads a freed
  intermediate), donation-aliasing safety, and — in strict mode —
  whole-plan-cache key completeness (every consumed value resolves to a
  structural token of the staged lowering).
* :func:`verify_rewrite` — the **rewrite-variant verifier** (RW001–RW004)
  over pairs of graphs produced by :mod:`repro_torch.core.rewrite`: output
  arity, output shape/dtype re-derived bottom-up via
  :func:`repro_torch.core.ir.infer_shape`, named-input set preservation, and
  sparse-zero-preservation (static zero-propagation: any output the
  original forces to zero when an input is all-zeros, the variant must
  force too).  :func:`verify_variant` bundles it with
  :func:`verify_graph` — the gate every rewrite variant passes before
  ``Traced.plan()`` will price it.

Two effort levels: ``"cheap"`` (O(plan) structural checks; the default at
the ``Traced.plan()`` / ``Planned.compile()`` stage boundaries) and
``"strict"`` (additionally builds every CPlan, replays the placement and
segment derivations, and exercises the whole-plan key — the
``FusionContext(verify="strict")`` / ``tools/fusionlint.py`` mode).

Severity policy: ``error`` means executing the plan could produce a wrong
result or crash; ``warning`` flags suspicious-but-executable structure.
:meth:`VerifyReport.raise_if_errors` turns error diagnostics into a
:class:`VerificationError` (a :class:`~repro_torch.core.partitions.
PlanInvariantError`), which is what the stage boundaries raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import ir
from .ir import Graph, sparse_safe_wrt
from .partitions import PlanInvariantError
from .templates import COMPAT, TType, _outer_mm, dist_epilogue

_EPILOGUES = ("none", "psum", "pmin", "pmax")


class VerificationError(PlanInvariantError):
    """A verifier error-severity diagnostic, raised at a stage boundary."""

    def __init__(self, report: "VerifyReport"):
        self.report = report
        lines = [f"plan verification failed "
                 f"({len(report.errors)} error(s)):"]
        lines += [f"  {d}" for d in report.errors]
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.

    ``code`` identifies the invariant (IRxxx / SELxxx / SEGxxx / CPLxxx /
    EXExxx — the catalog lives in ``docs/architecture.md``), ``node`` the
    offending graph node id (or spec/segment index where noted),
    ``fix_hint`` a one-line remediation."""

    code: str
    severity: str                       # "error" | "warning"
    node: Optional[int]
    message: str
    fix_hint: Optional[str] = None

    def __str__(self) -> str:
        loc = f" @node {self.node}" if self.node is not None else ""
        hint = f"  [{self.fix_hint}]" if self.fix_hint else ""
        return f"{self.code} {self.severity}{loc}: {self.message}{hint}"

    def as_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "node": self.node, "message": self.message,
                "fix_hint": self.fix_hint}


@dataclass
class VerifyReport:
    """All diagnostics of one verification pass."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    level: str = "cheap"

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_errors(self) -> None:
        if self.errors:
            raise VerificationError(self)

    def summary(self) -> dict:
        """The ``explain()`` verify section (JSON-stable)."""
        return {"level": self.level,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "diagnostics": [d.as_dict() for d in self.diagnostics]}

    def pretty(self) -> str:
        """Human-readable rendering (the ``fusionlint`` output)."""
        if not self.diagnostics:
            return f"ok ({self.level}): no diagnostics"
        lines = [f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s) [{self.level}]"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)


def _diag(out: list, code: str, sev: str, node, msg: str,
          hint: Optional[str] = None) -> None:
    out.append(Diagnostic(code, sev, node, msg, hint))


# --------------------------------------------------------------------------
# checker 1: the IR verifier (HOP DAG)
# --------------------------------------------------------------------------

def verify_graph(graph: Graph) -> list[Diagnostic]:
    """Structural + metadata invariants of a traced HOP DAG."""
    out: list[Diagnostic] = []
    pos = {n.nid: i for i, n in enumerate(graph.nodes)}

    if len(graph.by_id) != len(graph.nodes):
        _diag(out, "IR002", "error", None,
              "duplicate node id: single-producer SSA form violated",
              "every value must be produced by exactly one node")

    seen_names: dict[str, int] = {}
    cons: dict[int, list[int]] = {n.nid: [] for n in graph.nodes}
    for n in graph.nodes:
        # -- acyclicity / topological order / producer identity ------------
        for i in n.inputs:
            if graph.by_id.get(i.nid) is not i:
                _diag(out, "IR002", "error", n.nid,
                      f"input %{i.nid} of {n.op} is not the graph's "
                      f"producer for that id (stale or foreign node)",
                      "rebuild the graph via Graph.build")
                continue
            if pos[i.nid] >= pos[n.nid]:
                _diag(out, "IR001", "error", n.nid,
                      f"{n.op} reads %{i.nid} which is not ordered before "
                      f"it (cycle or broken topological order)")
            cons[i.nid].append(n.nid)

        # -- operator taxonomy ---------------------------------------------
        if n.op not in ir.ALL_OPS:
            _diag(out, "IR005", "error", n.nid, f"unknown op '{n.op}'")
            continue
        if n.op in ir.AGG_OPS and "axis" in n.attrs \
                and n.attrs["axis"] not in ("full", "row", "col"):
            _diag(out, "IR006", "error", n.nid,
                  f"aggregation {n.op} has invalid axis "
                  f"{n.attrs['axis']!r}", "axis must be full|row|col")

        # -- operand canonicalization ---------------------------------------
        if (not isinstance(n.shape, tuple) or len(n.shape) != 2
                or any((not isinstance(d, int)) or d < 1 for d in n.shape)):
            _diag(out, "IR009", "error", n.nid,
                  f"{n.op} shape {n.shape!r} is not a strictly-2-D "
                  f"positive (rows, cols) tuple",
                  "operands canonicalize to 2-D before planning")
            continue
        if n.op == "lit" and (n.shape != (1, 1) or "value" not in n.attrs
                              or n.inputs):
            _diag(out, "IR009", "error", n.nid,
                  "literal must be a leaf (1, 1) node carrying a "
                  "'value' attr")
        if n.op == "input":
            if not n.name:
                _diag(out, "IR009", "error", n.nid,
                      "input leaf has no bind-time name")
            elif n.name in seen_names:
                _diag(out, "IR011", "warning", n.nid,
                      f"duplicate input name '{n.name}' (also node "
                      f"%{seen_names[n.name]}): bindings are by name")
            else:
                seen_names[n.name] = n.nid

        # -- shape re-derivation (bottom-up) vs stored metadata --------------
        try:
            want = ir.infer_shape(n.op, [i.shape for i in n.inputs],
                                  n.attrs)
        except (ValueError, KeyError) as e:
            _diag(out, "IR003", "error", n.nid,
                  f"{n.op} has inconsistent operand shapes: {e}")
            want = None
        if want is not None and want != n.shape:
            _diag(out, "IR003", "error", n.nid,
                  f"stored shape {n.shape} != re-derived {want} for "
                  f"{n.op}({', '.join(str(i.shape) for i in n.inputs)})",
                  "shape metadata and semantics drifted")

        # -- dtype / sparsity metadata ---------------------------------------
        for i in n.inputs:
            if i.op != "lit" and i.dtype != n.dtype:
                _diag(out, "IR004", "warning", n.nid,
                      f"{n.op} dtype {n.dtype} != input %{i.nid} dtype "
                      f"{i.dtype}")
                break
        if not (0.0 <= n.sparsity <= 1.0 + 1e-9):
            _diag(out, "IR008", "warning", n.nid,
                  f"sparsity estimate {n.sparsity} outside [0, 1]")

    # -- outputs + consumer map ---------------------------------------------
    for o in graph.outputs:
        if graph.by_id.get(o.nid) is not o:
            _diag(out, "IR010", "error", o.nid,
                  "graph output is not a node of the graph")
    for nid, expect in cons.items():
        if sorted(graph.consumers.get(nid, [])) != sorted(expect):
            _diag(out, "IR007", "error", nid,
                  "consumers map inconsistent with the edge set",
                  "rebuild the graph via Graph.build")
    return out


# --------------------------------------------------------------------------
# checker 2: the CPlan / selection verifier
# --------------------------------------------------------------------------

def _spec_roots(spec) -> tuple[int, ...]:
    from .select import MultiAggSpec
    return tuple(spec.roots) if isinstance(spec, MultiAggSpec) \
        else (spec.root,)


def _is_fused(spec) -> bool:
    return bool(getattr(spec, "fused", False))


def _exploit_expr(graph: Graph, ttype, root):
    """The sub-expression whose cells must vanish where the sparse driver
    is zero (mirrors :func:`repro_torch.core.cost.find_driver`), or None when
    the root aggregation cannot skip zero cells at all."""
    if root.is_agg:
        if root.op not in ("sum", "sum_sq"):
            return None                 # min/max/mean see the zeros
        return root.inputs[0]
    if root.is_matmul:
        a, b = root.inputs
        return b if root.ta else a
    return root


def _check_cover(graph: Graph, out: list, spec, cover: dict,
                 root_nid: int, inputs: set) -> None:
    """SEL001/SEL002 for one (sub-)cover rooted at root_nid."""
    if root_nid not in cover:
        _diag(out, "SEL001", "error", root_nid,
              "fused operator root is not in its own cover")
        return
    reach = {root_nid}
    stack = [root_nid]
    while stack:
        for i in graph.by_id[stack.pop()].inputs:
            if i.nid in cover and i.nid not in reach:
                reach.add(i.nid)
                stack.append(i.nid)
    for nid in cover:
        if nid not in reach:
            _diag(out, "SEL001", "error", nid,
                  f"covered node %{nid} is unreachable from the root "
                  f"through the cover (disconnected fusion region)")
    boundary = {i.nid for nid in cover
                for i in graph.by_id[nid].inputs if i.nid not in cover}
    for nid in boundary - inputs:
        _diag(out, "SEL002", "error", nid,
              f"cover boundary value %{nid} is missing from the "
              f"operator's input list", "codegen could not bind it")
    for nid in inputs - boundary - set(cover):
        _diag(out, "SEL002", "warning", nid,
              f"listed input %{nid} is never consumed by the cover")


def _check_template(graph: Graph, out: list, spec) -> None:
    """SEL003: template applicability at the root + interior compat."""
    root = graph.by_id[spec.root]
    tt = spec.ttype
    ok = True
    if tt == TType.CELL:
        ok = root.is_cellwise or root.is_agg or root.op == "idx"
    elif tt == TType.ROW:
        ok = (root.is_cellwise or root.is_agg or root.is_matmul
              or root.op == "idx")
    elif tt == TType.MAGG:
        ok = root.is_agg and root.agg_axis == "full"
    elif tt == TType.OUTER:
        has_outer = any(_outer_mm(graph.by_id[nid]) for nid in spec.cover)
        if not has_outer:
            _diag(out, "SEL003", "error", spec.root,
                  "Outer template without an outer-product matmul in "
                  "its cover")
        if _outer_mm(root):
            _diag(out, "SEL003", "error", spec.root,
                  "Outer template rooted at the outer matmul itself "
                  "would materialize the dense m×n product",
                  "root at the consuming agg/matmul/cell chain instead")
    if not ok:
        _diag(out, "SEL003", "error", spec.root,
              f"{tt.name} template cannot root at op '{root.op}'")
    compat = COMPAT[tt]
    for nid, e in spec.cover.items():
        if nid != spec.root and e is not None and e.ttype not in compat:
            _diag(out, "SEL003", "error", nid,
                  f"interior entry of type {e.ttype.name} is not "
                  f"compatible with a {tt.name} fused operator")


def _check_sparse_safety(graph: Graph, out: list, spec) -> None:
    """SEL004: a sparsity-exploiting operator must be zero-preserving
    over the exploited (driver) input."""
    if spec.driver is None:
        return
    root = graph.by_id[spec.root]
    if spec.driver not in set(spec.inputs):
        _diag(out, "SEL004", "error", spec.driver,
              "sparse driver is not an input of the fused operator")
        return
    expr = _exploit_expr(graph, spec.ttype, root)
    if expr is None:
        _diag(out, "SEL004", "error", spec.root,
              f"aggregation '{root.op}' cannot skip the zero cells of a "
              f"sparse driver (non-linear over the skipped region)",
              "only sum/sum_sq aggregate sparse-exploited chains")
        return
    if not sparse_safe_wrt(expr, graph.by_id[spec.driver]):
        _diag(out, "SEL004", "error", spec.driver,
              f"fused chain is not zero-preserving w.r.t. driver "
              f"%{spec.driver}: evaluating only at its non-zeros would "
              f"be wrong", "clear spec.driver or re-run find_driver")


def _check_placement(graph: Graph, out: list, idx: int, spec,
                     params) -> None:
    """SEL011/SEL012/SEL013 for one distributed-placed operator."""
    from .cplan import variant_of
    from .select import MultiAggSpec

    pl = spec.placement
    if pl.epilogue not in _EPILOGUES:
        _diag(out, "SEL011", "error", spec.root,
              f"spec[{idx}] has unknown collective epilogue "
              f"{pl.epilogue!r}")
        return
    if isinstance(spec, MultiAggSpec):
        if pl.epilogue != "psum":
            _diag(out, "SEL011", "error", spec.root,
                  f"multi-aggregate epilogue must be psum, got "
                  f"{pl.epilogue!r}")
        for p in spec.parts:
            r = graph.by_id[p.root]
            if r.op not in ("sum", "sum_sq"):
                _diag(out, "SEL011", "error", p.root,
                      f"multi-aggregate member '{r.op}' has no psum-"
                      f"composable partial")
        rows = {graph.by_id[p.root].inputs[0].shape[0]
                for p in spec.parts}
    else:
        variant, agg_op, prog_root, _close = variant_of(
            graph, spec.ttype, graph.by_id[spec.root], set(spec.cover))
        want = dist_epilogue(spec.ttype, variant, agg_op)
        if want is None:
            _diag(out, "SEL011", "error", spec.root,
                  f"({spec.ttype.name}, {variant}) has no distributed "
                  f"variant but spec[{idx}] is placed distributed")
        elif pl.epilogue != want:
            _diag(out, "SEL011", "error", spec.root,
                  f"epilogue {pl.epilogue!r} does not match the "
                  f"template registry entry {want!r} for "
                  f"({spec.ttype.name}, {variant}, {agg_op or '-'})",
                  "see templates.DIST_VARIANTS")
        from .cost import _iter_rows
        rows = {_iter_rows(graph, spec, variant, prog_root)}
    if pl.n > 1:
        for r in rows:
            if r % pl.n:
                _diag(out, "SEL012", "error", spec.root,
                      f"iteration rows {r} not divisible by the "
                      f"row-shard degree {pl.n}")
    extra = set(pl.sharded) - set(spec.inputs)
    for nid in sorted(extra):
        _diag(out, "SEL013", "error", nid,
              f"placement marks %{nid} row-sharded but it is not an "
              f"input of spec[{idx}] (placement/binding drift)")


def _check_segments(graph: Graph, out: list, eplan) -> None:
    """SEG001–SEG006: each Segment's shard_map region must be
    representable — consistent row-shard group and data flow."""
    specs = eplan.specs
    for sidx, seg in enumerate(eplan.segments):
        idxs = seg.indices
        if list(idxs) != list(range(idxs[0], idxs[0] + len(idxs))):
            _diag(out, "SEG001", "error", sidx,
                  f"segment {sidx} indices {idxs} are not a contiguous "
                  f"run of the plan")
        pls = []
        for i in idxs:
            if i < 0 or i >= len(specs) or \
                    getattr(specs[i], "placement", None) is None or \
                    specs[i].placement.arm != "distributed":
                _diag(out, "SEG001", "error", sidx,
                      f"segment {sidx} member spec[{i}] is not a "
                      f"distributed-placed operator")
                return
            pls.append(specs[i].placement)
        groups = {(p.axes, p.n) for p in pls}
        if len(groups) > 1:
            _diag(out, "SEG002", "error", sidx,
                  f"segment {sidx} members disagree on the row-shard "
                  f"group: {sorted(groups)}")
        if (seg.axes, seg.n) not in groups:
            _diag(out, "SEG002", "error", sidx,
                  f"segment {sidx} header ({seg.axes}, {seg.n}) does "
                  f"not match its members")
        produced: dict[int, str] = {}
        ext_shard: dict[int, bool] = {}
        for i in idxs:
            pl = specs[i].placement
            for nid in specs[i].inputs:
                epil = produced.get(nid)
                if epil == "none" and nid not in pl.sharded:
                    _diag(out, "SEG003", "error", nid,
                          f"spec[{i}] reads the row-partitioned "
                          f"intra-segment value %{nid} unsharded "
                          f"(needs an in-region gather)")
                elif epil is not None and epil != "none" \
                        and nid in pl.sharded:
                    _diag(out, "SEG004", "error", nid,
                          f"spec[{i}] reads the reduced (replicated) "
                          f"value %{nid} as a row shard")
                elif epil is None:
                    sh = nid in pl.sharded
                    if nid in ext_shard and ext_shard[nid] != sh:
                        _diag(out, "SEG005", "error", nid,
                              f"external operand %{nid} is both "
                              f"sharded and broadcast inside segment "
                              f"{sidx}")
                    ext_shard[nid] = sh
            for r in _spec_roots(specs[i]):
                produced[r] = specs[i].placement.epilogue
        members = set(idxs)
        for (p, c, nid) in seg.sharded_edges:
            bad = (p not in members or c not in members or p >= c
                   or produced.get(nid) is None
                   or specs[p].placement.epilogue != "none"
                   or nid not in specs[c].placement.sharded)
            if bad:
                _diag(out, "SEG006", "error", nid,
                      f"segment {sidx} sharded edge ({p}->{c}, %{nid}) "
                      f"is inconsistent with member placements",
                      "producer must have a 'none' epilogue and the "
                      "consumer must read the value sharded")


def verify_selection(eplan, params=None,
                     strict: bool = False) -> list[Diagnostic]:
    """Checker 2: selection/CPlan invariants of an ExecPlan.

    ``params`` (a :class:`~repro_torch.core.cost.CostParams`) enables the
    constraint and placement-replay checks; defaults to the params the
    plan was selected under (``eplan.params``)."""
    from .select import MultiAggSpec

    graph = eplan.graph
    params = params if params is not None else eplan.params
    out: list[Diagnostic] = []

    produced: dict[int, int] = {}
    available = {n.nid for n in graph.nodes if n.is_input}
    consumed: set[int] = set()
    for idx, spec in enumerate(eplan.specs):
        roots = _spec_roots(spec)
        # -- dependency order / single production --------------------------
        for i in spec.inputs:
            consumed.add(i)
            if i not in available and i not in produced:
                _diag(out, "SEL007", "error", i,
                      f"spec[{idx}] reads %{i} before any operator "
                      f"produces it")
        for r in roots:
            if r in produced:
                _diag(out, "SEL006", "error", r,
                      f"%{r} is produced twice (spec[{produced[r]}] "
                      f"and spec[{idx}])")
            produced[r] = idx

        if not _is_fused(spec):
            continue
        # -- fused-operator structure --------------------------------------
        if isinstance(spec, MultiAggSpec):
            if len(spec.roots) != len(spec.parts) or not spec.parts:
                _diag(out, "SEL010", "error", spec.root,
                      f"multi-aggregate spec[{idx}] roots/parts "
                      f"mismatch")
                continue
            union_inputs: set[int] = set()
            for part in spec.parts:
                r = graph.by_id[part.root]
                if not (r.is_agg and r.agg_axis == "full"):
                    _diag(out, "SEL010", "error", part.root,
                          f"multi-aggregate member root '{r.op}' is "
                          f"not a full aggregation")
                _check_cover(graph, out, part, part.cover, part.root,
                             set(part.inputs))
                _check_template(graph, out, part)
                _check_sparse_safety(graph, out, part)
                union_inputs.update(part.inputs)
            if union_inputs != set(spec.inputs):
                _diag(out, "SEL002", "error", spec.root,
                      f"multi-aggregate spec[{idx}] inputs differ from "
                      f"the union of its members' inputs")
        else:
            _check_cover(graph, out, spec, spec.cover, spec.root,
                         set(spec.inputs))
            _check_template(graph, out, spec)
            _check_sparse_safety(graph, out, spec)
        if params is not None and \
                len(spec.inputs) > params.max_fused_inputs:
            _diag(out, "SEL005", "error", spec.root,
                  f"spec[{idx}] binds {len(spec.inputs)} inputs, over "
                  f"the fused-input constraint "
                  f"{params.max_fused_inputs}")
        pl = getattr(spec, "placement", None)
        if pl is not None and pl.arm == "distributed":
            _check_placement(graph, out, idx, spec, params)

    # -- outputs / dead operators -------------------------------------------
    for o in graph.output_ids:
        if o not in produced and o not in available:
            _diag(out, "SEL008", "error", o,
                  f"graph output %{o} is produced by no operator")
    for r, idx in produced.items():
        if r not in consumed and r not in graph.output_ids:
            _diag(out, "SEL009", "warning", r,
                  f"spec[{idx}] materializes %{r} but nothing "
                  f"consumes it (dead operator)")

    _check_segments(graph, out, eplan)
    if strict:
        out.extend(_verify_selection_strict(eplan, params))
    return out


def _verify_selection_strict(eplan, params) -> list[Diagnostic]:
    """SEL014 / SEG007 / CPL001–CPL004: CPlan construction and the
    placement/segment replay (the expensive, full-pass checks)."""
    from .cplan import build_cplan
    from .select import annotate_segments, resolved_placements

    graph = eplan.graph
    out: list[Diagnostic] = []

    # -- placement replay: pinned placements must equal a fresh walk -------
    if params is not None and params.dist is not None \
            and params.dist.n > 1:
        try:
            pls, _total = resolved_placements(graph, eplan.specs, params)
        except PlanInvariantError as e:
            _diag(out, "SEL014", "error", None,
                  f"placement replay raised: {e}")
            pls = None
        if pls is not None:
            for idx, (spec, pl) in enumerate(zip(eplan.specs, pls)):
                have = getattr(spec, "placement", None)
                if pl is None and have is None:
                    continue
                same = (pl is not None and have is not None
                        and pl.arm == have.arm
                        and pl.epilogue == have.epilogue
                        and pl.axes == have.axes and pl.n == have.n
                        and pl.sharded == have.sharded)
                if not same:
                    _diag(out, "SEL014", "error", spec.root,
                          f"spec[{idx}] pinned placement "
                          f"{have and have.arm}/{have and have.epilogue} "
                          f"disagrees with the replayed walk "
                          f"{pl and pl.arm}/{pl and pl.epilogue}",
                          "placements were mutated after selection")
            segs = annotate_segments(graph, eplan.specs, params)
            if segs != tuple(eplan.segments):
                _diag(out, "SEG007", "error", None,
                      "plan segments differ from a fresh "
                      "annotate_segments derivation",
                      "segments were mutated after selection")

    # -- CPlan construction + well-formedness -------------------------------
    for idx, spec in enumerate(eplan.specs):
        if not _is_fused(spec):
            continue
        try:
            cp = build_cplan(graph, spec)
        except Exception as e:            # noqa: BLE001 - report, not crash
            _diag(out, "CPL001", "error", spec.root,
                  f"spec[{idx}] CPlan construction failed: {e}")
            continue
        out.extend(_verify_cplan(graph, spec, cp, idx))
    return out


def _verify_cplan(graph, spec, cp, idx: int) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    mains = [b for b in cp.binds if b.kind == "main"]
    if not cp.binds or len(mains) != 1 or cp.binds[0].kind != "main":
        _diag(out, "CPL001", "error", spec.root,
              f"spec[{idx}] CPlan binding malformed: expected exactly "
              f"one main bind, first")
    bind_nids = {b.nid for b in cp.binds}
    prog_nids: set[int] = set()
    for (nid, op, ins, _shape, _attrs) in cp.prog:
        for ref in ins:
            kind, r = ref
            if kind == "n" and r not in prog_nids:
                _diag(out, "CPL002", "error", nid,
                      f"CPlan program op '{op}' references %{r} before "
                      f"it is computed")
            elif kind == "b" and r not in bind_nids:
                _diag(out, "CPL002", "error", nid,
                      f"CPlan program op '{op}' references unbound "
                      f"input %{r}")
        prog_nids.add(nid)
    known = prog_nids | bind_nids
    roots = [cp.prog_root] + [pr for pr, _ in cp.extra]
    if cp.close_nid is not None:
        roots.append(cp.close_nid)
    for r in roots:
        if r not in known:
            _diag(out, "CPL003", "error", spec.root,
                  f"spec[{idx}] CPlan root %{r} is neither computed by "
                  f"the program nor bound")
    root = graph.by_id[spec.root]
    expr = _exploit_expr(graph, cp.ttype, root)
    for b in cp.binds:
        if not b.exploit:
            continue
        if expr is None or not sparse_safe_wrt(expr, graph.by_id[b.nid]):
            sev = "error" if spec.driver == b.nid else "warning"
            _diag(out, "CPL004", sev, b.nid,
                  f"spec[{idx}] bind %{b.nid} is flagged "
                  f"sparsity-exploiting but the program is not "
                  f"zero-preserving w.r.t. it")
    return out


# --------------------------------------------------------------------------
# checker 3: the ExecPlan / codegen verifier
# --------------------------------------------------------------------------

def verify_exec(eplan, strict: bool = False, kernels: str = "never",
                last_uses: Optional[dict] = None,
                layout=None) -> list[Diagnostic]:
    """Checker 3: liveness soundness of ``_last_uses``, donation-aliasing
    safety, no-silent-fallback on real meshes (EXE005), and (strict)
    whole-plan-cache key completeness.

    ``last_uses`` injects a liveness map for testing; by default the one
    codegen executes (:func:`repro_torch.core.codegen._last_uses`) is
    simulated — with the same output-protection the runtime applies, so
    a diagnostic here means the *executed* plan would read a freed
    buffer.  ``layout`` enables EXE005: on a *real* mesh, every costed
    distributed placement must be realizable by the runtime — a
    placement the execution layer would quietly abandon is a costing
    bug, not an estimate (the plan priced a path it never takes)."""
    from .codegen import _last_uses as derive_last_uses

    graph = eplan.graph
    out: list[Diagnostic] = []
    lu = last_uses if last_uses is not None else derive_last_uses(eplan)

    outputs = set(graph.output_ids)
    live = {n.nid for n in graph.nodes if n.is_input}
    freed: dict[int, int] = {}            # nid -> spec idx that freed it
    ever = set(live)
    for idx, spec in enumerate(eplan.specs):
        for i in spec.inputs:
            if i in freed:
                _diag(out, "EXE001", "error", i,
                      f"spec[{idx}] reads %{i} which spec[{freed[i]}] "
                      f"already freed (liveness map is unsound)",
                      "a later consumer must extend the last use")
        live.update(_spec_roots(spec))
        ever.update(_spec_roots(spec))
        for dead in lu.get(idx, ()):
            if dead in outputs:
                continue                  # runtime never frees outputs
            if dead not in ever:
                _diag(out, "EXE002", "error", dead,
                      f"liveness map frees %{dead} at spec[{idx}] but "
                      f"it is never live")
            elif dead in live:
                live.discard(dead)
                freed[dead] = idx

    in_nids = {n.nid for n in graph.inputs()}
    for o in graph.output_ids:
        if o in in_nids:
            _diag(out, "EXE003", "warning", o,
                  f"graph input %{o} is returned as a plan output "
                  f"(aliasing hazard if the caller mutates results)",
                  "inputs are never donated, so this stays safe "
                  "read-only")

    if layout is not None:
        out.extend(_verify_exec_fallbacks(eplan, layout))
    if strict:
        out.extend(_verify_exec_strict(eplan, kernels))
    return out


def _verify_exec_fallbacks(eplan, layout) -> list[Diagnostic]:
    """EXE005 (no-silent-fallback): replay the distributed lowering's
    plan-time validation (:func:`repro_torch.core.codegen.plan_fallbacks`) and
    report every placement a *real* mesh cannot realize as an error —
    the runtime would downgrade those segments to local execution, so
    the plan's distributed cost priced a path execution never takes.
    On an abstract ``LogicalMesh`` the same downgrades are by design
    (cost-only planning) and reported as warnings."""
    from .codegen import _is_real_mesh, _mesh_of, plan_fallbacks

    out: list[Diagnostic] = []
    mesh = _mesh_of(layout)
    if mesh is None or not _is_real_mesh(mesh):
        # abstract LogicalMesh: local execution is cost-only planning by
        # design, and explain() reports it — nothing silent to flag
        return out
    for fb in plan_fallbacks(eplan, layout=layout):
        if fb.get("site") == "plan":
            continue                      # staged=False: user's choice
        specs = fb.get("specs")
        _diag(out, "EXE005", "error", None,
              f"distributed placement of spec(s) {specs} falls back to "
              f"local execution: {fb['reason']}",
              "the cost model priced the distributed arm; on a real "
              "mesh this is a silent-downgrade bug (strict raises at "
              "execution time)")
    return out


def _verify_exec_strict(eplan, kernels: str) -> list[Diagnostic]:
    """EXE004: every value the staged lowering wires must resolve to a
    structural token of the whole-plan cache key — a plan whose key
    computation cannot even name all consumed values would alias
    structurally different plans (or crash at lowering)."""
    from .codegen import staged_plan_key

    out: list[Diagnostic] = []
    try:
        staged_plan_key(eplan, kernels=kernels)
    except KeyError as e:
        _diag(out, "EXE004", "error", None,
              f"whole-plan cache key incomplete: value {e} has no "
              f"structural token (producer missing from the plan)")
    except Exception as e:                # noqa: BLE001 - report, not crash
        _diag(out, "EXE004", "error", None,
              f"whole-plan key computation failed: {e}")
    return out


# --------------------------------------------------------------------------
# checker 4: the rewrite-variant verifier (RW001–RW004)
# --------------------------------------------------------------------------

def _derived_shapes(graph: Graph) -> dict[int, tuple[int, int]]:
    """Output shapes re-derived bottom-up via :func:`ir.infer_shape`
    (stored metadata only where the op carries no derivable shape)."""
    d: dict[int, tuple[int, int]] = {}
    for n in graph.nodes:
        got = ir.infer_shape(n.op, [d[i.nid] for i in n.inputs], n.attrs)
        d[n.nid] = got if got is not None else n.shape
    return d


def _zero_forced(graph: Graph, input_name: str) -> tuple[bool, ...]:
    """Static zero-propagation: for each graph output, is it *forced* to
    all-zeros when the input named ``input_name`` is all-zeros?  The
    conservative lattice behind RW004: mul/matmul are zero if either
    operand is, div if the numerator is, add/sub if both are, full/row/col
    aggregates and zero-preserving unaries pass zero through, literals are
    zero iff their value is; everything else is assumed non-zero."""
    z: dict[int, bool] = {}
    for n in graph.nodes:
        if n.op == "input":
            r = n.name == input_name
        elif n.op == "lit":
            r = float(n.sparsity) == 0.0
        elif n.op in ("t", "idx", "diagv"):
            r = z[n.inputs[0].nid]
        elif n.op in ("matmul", "mul") and len(n.inputs) == 2:
            r = z[n.inputs[0].nid] or z[n.inputs[1].nid]
        elif n.op == "div":
            r = z[n.inputs[0].nid]
        elif n.op in ("add", "sub") and len(n.inputs) == 2:
            r = all(z[i.nid] for i in n.inputs)
        elif n.is_agg:
            r = z[n.inputs[0].nid]       # agg of all-zeros is zero (min/max incl.)
        elif n.op in ir.SPARSE_SAFE_UNARY:
            r = z[n.inputs[0].nid]
        else:
            r = False
        z[n.nid] = r
    return tuple(z[o.nid] for o in graph.outputs)


def verify_rewrite(original: Graph, variant: Graph) -> list[Diagnostic]:
    """RW001–RW004: is ``variant`` a legal rewrite of ``original``?

    * **RW001** — output arity preserved.
    * **RW002** — per-output shape and dtype preserved, shapes re-derived
      bottom-up via :func:`ir.infer_shape` (a rule that miscomputes a
      replacement shape is caught here even if its stored metadata
      self-consistently lies).
    * **RW003** — named-input set preserved, with per-name shape/dtype
      agreement (the planned backward keys gradients by input name; a
      variant that drops or retypes an input breaks it).
    * **RW004** — sparse-zero-preservation: every output the original
      statically forces to zero when some input is all-zeros, the variant
      must force to zero too — otherwise sparsity exploitation over the
      rewritten form could read cells the original never produced.
    """
    out: list[Diagnostic] = []
    if len(variant.outputs) != len(original.outputs):
        _diag(out, "RW001", "error", None,
              f"rewrite changed output arity: "
              f"{len(original.outputs)} -> {len(variant.outputs)}",
              "a rule must replace a node with exactly one root")
        return out                       # positional checks are meaningless

    do = _derived_shapes(original)
    dv = _derived_shapes(variant)
    for i, (a, b) in enumerate(zip(original.outputs, variant.outputs)):
        if do[a.nid] != dv[b.nid]:
            _diag(out, "RW002", "error", b.nid,
                  f"rewrite changed output[{i}] shape: "
                  f"{do[a.nid]} -> {dv[b.nid]} (re-derived)",
                  "every rule must be shape-preserving on its match")
        if a.dtype != b.dtype:
            _diag(out, "RW002", "error", b.nid,
                  f"rewrite changed output[{i}] dtype: "
                  f"{a.dtype} -> {b.dtype}")

    ins_o = {n.name: n for n in original.inputs()}
    ins_v = {n.name: n for n in variant.inputs()}
    if set(ins_o) != set(ins_v):
        _diag(out, "RW003", "error", None,
              f"rewrite changed the named-input set: "
              f"{sorted(ins_o)} -> {sorted(ins_v)}",
              "planned backward keys gradients by input name")
    else:
        for name in sorted(ins_o):
            a, b = ins_o[name], ins_v[name]
            if a.shape != b.shape or a.dtype != b.dtype:
                _diag(out, "RW003", "error", b.nid,
                      f"rewrite retyped input '{name}': "
                      f"{a.shape}/{a.dtype} -> {b.shape}/{b.dtype}")
        for name in sorted(ins_o):
            zo = _zero_forced(original, name)
            zv = _zero_forced(variant, name)
            for i, (fo, fv) in enumerate(zip(zo, zv)):
                if fo and not fv:
                    _diag(out, "RW004", "error", None,
                          f"rewrite loses sparse-zero-preservation: "
                          f"output[{i}] is zero-forced by input "
                          f"'{name}' in the original but not in the "
                          f"variant",
                          "the rewritten expression must stay "
                          "zero-preserving over every input the "
                          "original is")
    return out


def verify_variant(original: Graph, variant: Graph,
                   level: str = "cheap") -> VerifyReport:
    """The rewrite-variant gate: IR-verify the variant graph, then check
    the RW001–RW004 pair invariants against the original.  Variants with
    a non-``ok`` report are rejected before planning (and recorded in
    ``explain()["rewrite"]["rejected"]``)."""
    assert level in ("off", "cheap", "strict"), level
    report = VerifyReport(level=level)
    if level == "off":
        return report
    report.diagnostics.extend(verify_graph(variant))
    report.diagnostics.extend(verify_rewrite(original, variant))
    return report


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def verify_plan(eplan, level: str = "cheap", params=None,
                kernels: str = "never", layout=None) -> VerifyReport:
    """Run every checker over an ExecPlan at the given effort level.

    ``"cheap"`` — O(plan) structural checks (the stage-boundary default);
    ``"strict"`` — additionally builds every CPlan, replays placements
    and segments, and exercises the whole-plan cache key; ``"off"`` —
    empty report.  ``layout`` enables the EXE005 no-silent-fallback
    check against a real mesh."""
    assert level in ("off", "cheap", "strict"), level
    report = VerifyReport(level=level)
    if level == "off":
        return report
    strict = level == "strict"
    report.diagnostics.extend(verify_graph(eplan.graph))
    report.diagnostics.extend(
        verify_selection(eplan, params=params, strict=strict))
    report.diagnostics.extend(
        verify_exec(eplan, strict=strict, kernels=kernels, layout=layout))
    return report
