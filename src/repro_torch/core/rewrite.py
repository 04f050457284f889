"""Rewrite-based plan exploration (SPORES-style, PAPERS.md 2002.07951).

The explorer enumerates fusion plans over the HOP DAG *as written*; this
module widens the plan space with a bounded algebraic rewrite pass between
``trace`` and ``plan``: it generates semantically-equal DAG variants from a
small, documented rule set, each of which ``Traced.plan()`` verifies
(:func:`repro_torch.core.verify.verify_variant`, RW001–RW004), plans through the
existing explore → select pipeline, and admits into the global cost argmin.
``explain()["rewrite"]`` reports the rules applied, per-variant cost, and
the winner; the winning rule chain also enters the whole-plan cache key
(:func:`repro_torch.core.codegen.staged_plan_key`).

Rule catalog (all over *full* aggregates — the bounded set; shapes in
comments use M:(m,k), N:(k,n), A:(m,n)):

``spores_rotate``
    ``sum((M@N) ⊙ A)  ⇄  sum((A@Nᵀ) ⊙ M)  ⇄  sum((Mᵀ@A) ⊙ N)`` — the
    SPORES sum-product rotation.  The matmul under the aggregate moves to
    whichever pair of operands contracts cheapest; with one factor sparse
    it exposes the sparsity-exploiting Outer form.  (The classical
    ``trace(X@Y) → sum(X ⊙ Yᵀ)`` identity is this rotation with ``A = I``;
    the 2-D IR has no trace/diag expression, so the identity appears only
    through its ⊙-form, which these rotations cover.)
``sum_transpose``
    ``agg_full(Xᵀ) → agg_full(X)`` for sum/sum_sq/min/max/mean — a full
    aggregate is permutation-invariant, so the transpose is dead.
``sum_mm_factor``
    ``sum(M@N) → sum(colsums(M)ᵀ ⊙ rowsums(N))`` — sum-of-product
    reassociation: Σᵢⱼₖ MᵢₖNₖⱼ contracted as Σₖ (ΣᵢMᵢₖ)(ΣⱼNₖⱼ), turning an
    O(mkn) contraction with an (m,n) intermediate into two vector sums.
``sum_add_split``
    ``sum(A ± B) → sum(A) ± sum(B)`` when A and B have the full shape, or
    ``sum(A ± s) → sum(A) ± ncells·s`` for a scalar operand — distributing
    ``sum`` over ``+`` so each term aggregates (and fuses) independently.
``scalar_hoist``
    ``sum(A ⊙ s) → s ⊙ sum(A)`` and ``sum(A / s) → sum(A) / s`` for scalar
    ``s`` — hoists the scalar out of the aggregate so the reduction runs
    over the raw cells.

Every rule preserves output shape/dtype, the named-input set, and static
zero-forcing w.r.t. each input (sparse-zero-preservation) — the properties
RW001–RW004 re-check per variant, so an ill-formed rule application is
rejected before it can be planned.

The engine is a bounded breadth-first closure: rules are applied at every
matching node in topological order, compositions up to ``max_depth`` deep,
deduplicated by structural digest, truncated at ``max_variants``.  Rule
applications are labelled ``"<rule>@<topo-index>"`` (topological position,
not node id) so variant identity is stable across re-traces of the same
expression — the property the whole-plan cache key and the golden explain
snapshots rely on.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable

from .ir import Expr, Graph, Node

#: bounded search knobs (module-level so tests/tools can widen them)
MAX_VARIANTS = 16
MAX_DEPTH = 2

#: full-aggregate ops every rule keys on
_FULL_AGGS = ("sum", "sum_sq", "min", "max", "mean")


def graph_digest(graph: Graph) -> str:
    """Structural sha256 of a HOP DAG with node ids canonicalized to
    topological indices — equal for structurally-equal graphs from
    different traces, the dedup/identity token of the rewrite engine."""
    idx = {n.nid: i for i, n in enumerate(graph.nodes)}
    toks: list = []
    for n in graph.nodes:
        toks.append((n.op, n.name or "", n.shape, str(n.dtype),
                     round(float(n.sparsity), 6),
                     tuple(sorted((k, repr(v)) for k, v in n.attrs.items())),
                     tuple(idx[i.nid] for i in n.inputs)))
    toks.append(("outputs", tuple(idx[o.nid] for o in graph.outputs)))
    return hashlib.sha256(repr(toks).encode()).hexdigest()


@dataclass(frozen=True)
class RewriteVariant:
    """One semantically-equal DAG produced by the rewrite pass."""

    graph: Graph
    #: rule-application chain, e.g. ``("spores_rotate@7",)``
    rules: tuple[str, ...]
    #: structural digest of :attr:`graph` (see :func:`graph_digest`)
    digest: str


# --------------------------------------------------------------------------
# rule implementations
# --------------------------------------------------------------------------
#
# A rule is ``fn(node) -> list[Node]``: zero or more replacement roots for
# ``node``, each built over the *original* operand nodes (so the engine's
# graph rebuild shares everything below the match).  Construction goes
# through the Expr layer, which keeps shape/sparsity propagation and
# transpose folding identical to trace-time construction.

def _full_agg(node: Node, ops=_FULL_AGGS) -> bool:
    return node.is_agg and node.agg_axis == "full" and node.op in ops


def _logical_mm(mm: Node) -> tuple[Expr, Expr]:
    """The logical (M, N) operands of a matmul with its ta/tb flags
    unfolded into explicit transposes (Expr.T collapses t(t(X)))."""
    a, b = mm.inputs
    M = Expr(a).T if mm.ta else Expr(a)
    N = Expr(b).T if mm.tb else Expr(b)
    return M, N


def rule_spores_rotate(node: Node) -> list[Node]:
    """sum((M@N) ⊙ A) ⇄ sum((A@Nᵀ) ⊙ M) ⇄ sum((Mᵀ@A) ⊙ N)."""
    if not _full_agg(node, ops=("sum",)):
        return []
    x = node.inputs[0]
    if x.op != "mul":
        return []
    out: list[Node] = []
    for mm, other in (x.inputs, x.inputs[::-1]):
        if not mm.is_matmul or other.shape != mm.shape:
            continue                     # rotation needs a non-broadcast ⊙
        M, N = _logical_mm(mm)
        A = Expr(other)
        out.append(((A @ N.T) * M).sum().node)
        out.append(((M.T @ A) * N).sum().node)
    return out


def rule_sum_transpose(node: Node) -> list[Node]:
    """agg_full(t(X)) → agg_full(X): full aggregates ignore cell order."""
    if not _full_agg(node):
        return []
    x = node.inputs[0]
    if x.op != "t":
        return []
    return [Expr(x.inputs[0])._agg(node.op, "full").node]


def rule_sum_mm_factor(node: Node) -> list[Node]:
    """sum(M@N) → sum(colsums(M)ᵀ ⊙ rowsums(N)): Σₖ (ΣᵢMᵢₖ)(ΣⱼNₖⱼ)."""
    if not _full_agg(node, ops=("sum",)):
        return []
    mm = node.inputs[0]
    if not mm.is_matmul:
        return []
    M, N = _logical_mm(mm)
    return [(M.colsums().T * N.rowsums()).sum().node]


def rule_sum_add_split(node: Node) -> list[Node]:
    """sum(A ± B) → sum(A) ± sum(B) (full-shape or scalar operands)."""
    if not _full_agg(node, ops=("sum",)):
        return []
    x = node.inputs[0]
    if x.op not in ("add", "sub"):
        return []
    terms: list[Expr] = []
    for side in x.inputs:
        if side.shape == x.shape:
            terms.append(Expr(side).sum())
        elif side.is_scalar:
            # a scalar broadcast over the sum's cells contributes ncells·s
            terms.append(Expr(side) * float(x.ncells))
        else:
            return []                   # row/col broadcast: out of scope
    a, b = terms
    return [(a + b).node if x.op == "add" else (a - b).node]


def rule_scalar_hoist(node: Node) -> list[Node]:
    """sum(A ⊙ s) → s ⊙ sum(A);  sum(A / s) → sum(A) / s  (s scalar)."""
    if not _full_agg(node, ops=("sum",)):
        return []
    x = node.inputs[0]
    if x.op == "mul":
        a, b = x.inputs
        if b.is_scalar and not a.is_scalar:
            return [(Expr(b) * Expr(a).sum()).node]
        if a.is_scalar and not b.is_scalar:
            return [(Expr(a) * Expr(b).sum()).node]
    elif x.op == "div":
        a, b = x.inputs
        if b.is_scalar and not a.is_scalar:
            return [(Expr(a).sum() / Expr(b)).node]
    return []


#: the documented rule set, applied in this (deterministic) order
RULES: tuple[tuple[str, Callable[[Node], list[Node]]], ...] = (
    ("spores_rotate", rule_spores_rotate),
    ("sum_transpose", rule_sum_transpose),
    ("sum_mm_factor", rule_sum_mm_factor),
    ("sum_add_split", rule_sum_add_split),
    ("scalar_hoist", rule_scalar_hoist),
)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def _replace_node(graph: Graph, target_nid: int, replacement: Node) -> Graph:
    """Rebuild ``graph`` with ``target_nid`` substituted by ``replacement``
    (whose subtree references original nodes below the target, so the
    rebuild shares everything else; Graph.build re-runs CSE)."""
    memo: dict[int, Node] = {}

    def rb(n: Node) -> Node:
        got = memo.get(n.nid)
        if got is not None:
            return got
        if n.nid == target_nid:
            memo[n.nid] = replacement
            return replacement
        ins = tuple(rb(i) for i in n.inputs)
        nn = n if ins == n.inputs else Node(
            n.op, ins, n.shape, n.dtype, n.sparsity, n.name, dict(n.attrs))
        memo[n.nid] = nn
        return nn

    return Graph.build([rb(o) for o in graph.outputs])


def applicable(graph: Graph) -> bool:
    """Cheap prefilter: can any rule possibly match this DAG?"""
    return any(_full_agg(n) for n in graph.nodes)


def rewrite_variants(graph: Graph, max_variants: int = MAX_VARIANTS,
                     max_depth: int = MAX_DEPTH,
                     rules=RULES) -> list[RewriteVariant]:
    """Bounded BFS closure of the rule set over ``graph``.

    Deterministic: nodes are visited in topological order and rules in
    catalog order, so the same expression always yields the same variant
    list (labels use topological indices, stable across re-traces).  The
    original graph itself is never in the result."""
    if not applicable(graph):
        return []
    seen = {graph_digest(graph)}
    out: list[RewriteVariant] = []
    frontier: list[tuple[Graph, tuple[str, ...]]] = [(graph, ())]
    for _depth in range(max_depth):
        nxt: list[tuple[Graph, tuple[str, ...]]] = []
        for g, chain in frontier:
            for topo, node in enumerate(g.nodes):
                for rname, fn in rules:
                    for ri, rep in enumerate(fn(node)):
                        if len(out) >= max_variants:
                            return out
                        ng = _replace_node(g, node.nid, rep)
                        d = graph_digest(ng)
                        if d in seen:
                            continue
                        seen.add(d)
                        # rules yielding several replacements at one site
                        # get a .k suffix so every chain label is unique
                        lab = (f"{rname}@{topo}" if ri == 0
                               else f"{rname}@{topo}.{ri}")
                        v = RewriteVariant(ng, chain + (lab,), d)
                        out.append(v)
                        nxt.append((ng, v.rules))
        frontier = nxt
        if not frontier:
            break
    return out
