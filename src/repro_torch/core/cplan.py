"""Code-generation plans (CPlans) — paper §2.2.

A CPlan is the backend-independent representation of one fused operator:
a template type + variant, a *data binding* (main input, side inputs,
scalars), and a DAG of basic operations (the CNode program).  Code
generation expands the template skeleton and splices the program in; here
the "generated code" is a traced function — the program is interpreted at
JAX/Pallas **trace time**, so the emitted kernel/XLA computation is exactly
as fused as SystemML's janino-compiled operator (zero interpretation
overhead at run time).

CPlans hash structurally (ops, shapes, binding, variant) — the key of the
plan cache (paper §2.1 "identifies equivalent CPlans via hashing").
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Optional

from .cost import FusedOpSpec
from .ir import Graph, Node
from .select import MultiAggSpec
from .templates import TType

# variants (paper Table 1)
NO_AGG, ROW_AGG, COL_AGG, FULL_AGG, COL_T_AGG, RIGHT_MM, LEFT_MM = (
    "no_agg", "row_agg", "col_agg", "full_agg", "col_t_agg",
    "right_mm", "left_mm")


@dataclass
class CBind:
    """One bound input of the fused operator."""
    nid: int
    kind: str                 # "main" | "side" | "scalar" | "factor_u" | "factor_v"
    shape: tuple[int, int]
    sparsity: float = 1.0
    #: True iff the planner certified the chain sparse-safe w.r.t. this
    #: (main) input — gates the block-sparse execution path.
    exploit: bool = False


@dataclass
class CPlan:
    ttype: TType
    variant: str
    agg_op: str                          # sum/min/max/mean ('' if none)
    binds: list[CBind]                   # main first
    #: covered nodes in topo order: (nid, op, input keys, shape, attrs)
    #: input key: ('n', nid) covered node | ('b', bind index) bound input
    prog: list[tuple]
    prog_root: int                       # nid whose value the skeleton closes
    out_shape: tuple[int, int]
    roots: tuple[int, ...] = ()          # >1 for multi-aggregates
    #: per extra root (multi-agg): (prog_root, agg_op)
    extra: tuple[tuple[int, str], ...] = ()
    close_tb: bool = False               # right_mm: chain @ t(V)?
    #: second operand of the closing matmul (col_t_agg: X; right_mm: V;
    #: left_mm: U) — a bind nid or a covered node computed by the program.
    close_nid: Optional[int] = None

    @property
    def main(self) -> CBind:
        return self.binds[0]

    def side_binds(self) -> list[CBind]:
        return [b for b in self.binds[1:]]

    def cache_key(self) -> str:
        """Structural hash: node ids canonicalized to local indices so that
        re-traced but structurally identical CPlans hit the plan cache."""
        local: dict[int, str] = {b.nid: f"b{i}"
                                 for i, b in enumerate(self.binds)}
        for j, (nid, *_rest) in enumerate(self.prog):
            local[nid] = f"n{j}"

        def canon(ref):
            kind, r = ref
            return (kind, local.get(r, r) if kind in ("n", "b") else r)

        h = hashlib.sha256()
        h.update(repr((
            self.ttype, self.variant, self.agg_op,
            [(b.kind, b.shape, round(b.sparsity, 6), b.exploit)
             for b in self.binds],
            [(op, tuple(canon(i) for i in ins), shape, attrs)
             for (_, op, ins, shape, attrs) in self.prog],
            local.get(self.prog_root, self.prog_root),
            self.out_shape, self.close_tb,
            local.get(self.close_nid, self.close_nid),
            tuple((local.get(pr, pr), op) for pr, op in self.extra),
        )).encode())
        return h.hexdigest()[:16]


# --------------------------------------------------------------------------
# the CPlan of one row panel (distributed segments)
# --------------------------------------------------------------------------

def panel_cplan(cplan: CPlan, rows: int, panels: frozenset) -> CPlan:
    """``cplan`` over a row panel of ``rows`` of its main's rows: the
    binds in ``panels`` (nids bound to row panels) take ``rows`` rows, and
    so does every program value computed row-aligned from them — an
    element-wise or row-aggregate value of a panel, and a matmul whose
    left operand is one (not ``ta``: Xᵀ·G sums over rows, its result is
    a per-rank partial of the whole shape).  The output takes ``rows``
    rows for the variants whose output rows are the main's (``no_agg``,
    ``row_agg``, ``right_mm``).  Row alignment is read from the program,
    never from a shape that happens to equal the main's row count.
    Memoized; the generated kernel source does not depend on the row
    count, so a panel CPlan shares its whole-operand build."""
    key = (id(cplan), int(rows), panels)
    hit = _PANELS.get(key)
    if hit is not None and hit[0] is cplan:
        return hit[1]
    out = _panel_cplan(cplan, int(rows), panels)
    if len(_PANELS) >= 1024:
        _PANELS.clear()
    _PANELS[key] = (cplan, out)
    return out


#: panel CPlans by (CPlan object, rows, panel binds); the object is kept
#: beside its panel CPlan, so a reused id never hits
_PANELS: dict[tuple, tuple[CPlan, CPlan]] = {}


def _panel_cplan(cplan: CPlan, rows: int, panels: frozenset) -> CPlan:
    aligned = set(b.nid for b in cplan.binds if b.nid in panels)
    fit = lambda shape: (rows, shape[1])
    prog = []
    for (nid, op, ins, shape, attrs) in cplan.prog:
        a = dict(attrs)
        srcs = [r for k, r in ins if k in ("n", "b") and r in aligned]
        if op == "matmul":
            row = ins[0][1] in aligned and ins[0][0] in ("n", "b") \
                and not a.get("ta", False)
        elif "axis" in a:
            row = a["axis"] == "row" and bool(srcs)
        elif op == "t":
            row = False
        else:
            row = bool(srcs) and shape[0] > 1
        if row:
            aligned.add(nid)
            shape = fit(shape)
        prog.append((nid, op, ins, shape, attrs))
    binds = [replace(b, shape=fit(b.shape)) if b.nid in panels else b
             for b in cplan.binds]
    out = fit(cplan.out_shape) \
        if cplan.main.nid in panels and cplan.variant in (
            NO_AGG, ROW_AGG, RIGHT_MM) else cplan.out_shape
    return replace(cplan, binds=binds, prog=prog, out_shape=out)


# --------------------------------------------------------------------------
# CPlan construction from a selected fusion plan
# --------------------------------------------------------------------------

def build_cplan(graph: Graph, spec) -> CPlan:
    if isinstance(spec, MultiAggSpec):
        return _build_multi_agg(graph, spec)
    assert isinstance(spec, FusedOpSpec) and spec.ttype is not None
    root = graph.by_id[spec.root]
    cover = set(spec.cover)

    variant, agg_op, prog_root, close_operand = _variant_of(
        graph, spec.ttype, root, cover)

    inputs = _effective_inputs(graph, spec, cover)
    binds = _bind_inputs(graph, spec, inputs, prog_root, close_operand)
    roots = [prog_root] + ([close_operand] if close_operand is not None
                           else [])
    prog = _linearize(graph, cover, {b.nid for b in binds}, *roots)
    return CPlan(spec.ttype, variant, agg_op, binds, prog, prog_root,
                 root.shape, roots=(spec.root,),
                 close_tb=bool(root.is_matmul and root.tb),
                 close_nid=close_operand)


def _build_multi_agg(graph: Graph, spec: MultiAggSpec) -> CPlan:
    binds: list[CBind] = []
    bound: set[int] = set()
    for part in spec.parts:
        cp = build_cplan(graph, part)
        for b in cp.binds:
            if b.nid not in bound:
                bound.add(b.nid)
                binds.append(b)
    # keep exactly one main (the first); demote other mains to sides
    main_seen = False
    norm: list[CBind] = []
    for b in binds:
        if b.kind == "main":
            if main_seen:
                b = CBind(b.nid, "side", b.shape, b.sparsity)
            main_seen = True
        norm.append(b)
    norm.sort(key=lambda b: b.kind != "main")
    cover: set[int] = set()
    for part in spec.parts:
        cover.update(part.cover)
    roots = [graph.by_id[r] for r in spec.roots]
    prog_roots = [r.inputs[0].nid for r in roots]
    prog = _linearize(graph, cover, {b.nid for b in norm}, *prog_roots)
    return CPlan(TType.MAGG, FULL_AGG, roots[0].op, norm, prog,
                 prog_roots[0], (len(roots), 1),
                 roots=tuple(spec.roots),
                 extra=tuple((pr, r.op) for pr, r in
                             zip(prog_roots[1:], roots[1:])))


def _variant_of(graph: Graph, ttype: TType, root: Node, cover: set[int]):
    """(variant, agg_op, prog_root, close_operand_nid)."""
    if root.is_agg:
        ax = root.agg_axis
        variant = {"full": FULL_AGG, "row": ROW_AGG, "col": COL_AGG}[ax]
        return variant, root.op, root.inputs[0].nid, None
    if root.is_matmul and ttype == TType.ROW:
        if root.ta and not root.tb:
            # t(X) @ chain — column-transposed aggregation
            return COL_T_AGG, "sum", root.inputs[1].nid, root.inputs[0].nid
        # (chain) @ B — stays row-wise; the matmul runs inside the program.
        # (t(A) @ t(B) also lands here defensively: the program evaluates
        # the matmul with both transpose flags — templates refuse to open
        # such roots, see templates._narrow_mm.)
        return NO_AGG, "", root.nid, None
    if root.is_matmul and ttype == TType.OUTER:
        a, b = root.inputs
        if root.ta:      # t(chain) @ U  — left_mm
            return LEFT_MM, "sum", b.nid, a.nid
        return RIGHT_MM, "sum", a.nid, b.nid
    return NO_AGG, "", root.nid, None


#: public accessor for the plan verifier and cost model — the
#: (variant, agg_op, prog_root, close_operand_nid) classification is the
#: single source of a fused operator's execution variant
variant_of = _variant_of


def _effective_inputs(graph: Graph, spec: FusedOpSpec,
                      cover: set[int]) -> list[int]:
    """Spec inputs, with covered idx-nodes over raw inputs folded: the
    wrapper slices the base matrix, so the idx node acts as the leaf."""
    inputs = list(spec.inputs)
    for nid in cover:
        n = graph.by_id[nid]
        if n.op == "idx" and n.inputs[0].nid in inputs:
            pass                       # base stays; idx evaluated in program
    return inputs


def _bind_inputs(graph: Graph, spec: FusedOpSpec, inputs: list[int],
                 prog_root: int, close_operand: Optional[int]) -> list[CBind]:
    inputs = [i for i in inputs if graph.by_id[i].op != "lit"]
    nodes = {i: graph.by_id[i] for i in inputs}
    scalars = [i for i in inputs if nodes[i].is_scalar]
    mats = [i for i in inputs if not nodes[i].is_scalar]

    main: Optional[int] = None
    factor_u: Optional[int] = None
    factor_v: Optional[int] = None

    if spec.ttype == TType.OUTER:
        mm = _find_outer_mm(graph, spec)
        a, b = mm.inputs
        factor_u, factor_v = a.nid, b.nid
        main = spec.driver
        if main is None:   # structurally guaranteed by close(), but be safe
            cands = [i for i in mats if i not in (factor_u, factor_v)]
            main = cands[0] if cands else factor_u
    elif spec.driver is not None:
        main = spec.driver
    if main is None:
        # largest matrix whose rows match the iteration domain
        target_rows = graph.by_id[close_operand].shape[0] if close_operand \
            else graph.by_id[prog_root].shape[0]
        ranked = sorted(
            mats, key=lambda i: (nodes[i].shape[0] == target_rows,
                                 nodes[i].ncells), reverse=True)
        main = ranked[0] if ranked else scalars[0]

    binds = [CBind(main, "main", nodes.get(main, graph.by_id[main]).shape,
                   graph.by_id[main].sparsity,
                   exploit=(spec.driver == main
                            or spec.ttype == TType.OUTER))]
    if close_operand is not None and close_operand not in inputs \
            and spec.ttype == TType.ROW:
        # col_t_agg closes against X, which may equal main — nothing to add
        pass
    for i in inputs:
        if i == main:
            continue
        kind = "scalar" if graph.by_id[i].is_scalar else "side"
        if i == factor_u:
            kind = "factor_u"
        elif i == factor_v:
            kind = "factor_v"
        binds.append(CBind(i, kind, graph.by_id[i].shape,
                           graph.by_id[i].sparsity))
    return binds


def _find_outer_mm(graph: Graph, spec: FusedOpSpec) -> Node:
    from .templates import _outer_mm
    for nid in spec.cover:
        n = graph.by_id[nid]
        if n.is_matmul and _outer_mm(n):
            return n
    raise AssertionError("outer template without outer matmul")


def _linearize(graph: Graph, cover: set[int], bound: set[int],
               *roots: int) -> list[tuple]:
    """Topo-ordered program over covered nodes reachable from the roots."""
    order: list[tuple] = []
    seen: set[int] = set()

    def visit(nid: int) -> None:
        if nid in seen or nid in bound:
            return
        seen.add(nid)
        node = graph.by_id[nid]
        assert nid in cover or node.is_input or node.op == "lit", \
            f"node {node} escapes cover"
        ins = []
        for i in node.inputs:
            if i.nid in bound or (i.nid not in cover and not i.op == "lit"):
                ins.append(("b", i.nid))
            elif i.op == "lit":
                ins.append(("l", float(i.attrs["value"])))
            else:
                visit(i.nid)
                ins.append(("n", i.nid))
        order.append((nid, node.op, tuple(ins), node.shape,
                      tuple(sorted(node.attrs.items()))))

    for r in roots:
        if r not in bound:
            visit(r)
    return order
