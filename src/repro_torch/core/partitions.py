"""Plan partitions and interesting points (paper §4.2).

Plan partitions are the connected components of the *maximal DAG of fusion
references* — nodes unreachable via fusion are independent, so each
partition is optimized and costed separately.  Per partition we determine
root nodes, input nodes, materialization points (multiple consumers), and
the **interesting points** M'_i that span the 2^|M'_i| search space:

  - *materialization-point consumers* ``(g → m)``: one boolean per consuming
    data dependency of a multi-consumer node (fine-grained, so overlapping
    fused operators are not forced to re-read materialized intermediates);
  - *template switches* ``(g_i → g_j)`` where W[g_j] contains template types
    absent from W[g_i] (e.g. a Cell consumer that would destroy a
    sparsity-exploiting Outer below — paper's Y + X ⊙ UVᵀ example).

A point assigned **true** bans fusion along that dependency (all plans with
that reference become invalid); false leaves the choice to plan probing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Graph
from .memo import MemoTable

#: an interesting point is a data dependency (consumer_nid, input_nid)
Point = tuple[int, int]


class PlanInvariantError(Exception):
    """A fusion plan violated a structural invariant the pipeline relies
    on — an inconsistent placement/segment assignment, a binding that
    cannot be wired, or (via :class:`repro_torch.core.verify.VerificationError`)
    any error-severity verifier diagnostic.  Raised instead of silently
    producing a plan that would compute a wrong result."""


@dataclass
class Partition:
    nodes: set[int]                       # group ids with fusion plans
    roots: list[int]                      # never referenced within partition
    inputs: set[int]                      # read by partition, not in it
    mat_points: list[int]                 # multi-consumer nodes (no roots)
    points: list[Point]                   # interesting points M'_i
    #: extra nodes whose output leaves the partition (consumed by ops
    #: outside it or graph outputs) — they must be materialized too.
    exits: set[int] = field(default_factory=set)


def build_partitions(graph: Graph, memo: MemoTable) -> list[Partition]:
    plan_nodes = {nid for nid in memo.groups() if memo.entries(nid)}
    if not plan_nodes:
        return []

    # union-find over fusion references (the maximal reference DAG)
    parent = {nid: nid for nid in plan_nodes}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    referenced: set[int] = set()
    for nid in plan_nodes:
        for e in memo.entries(nid):
            for r in e.ref_ids():
                if r in plan_nodes:
                    union(nid, r)
                    referenced.add(r)

    comps: dict[int, set[int]] = {}
    for nid in plan_nodes:
        comps.setdefault(find(nid), set()).add(nid)

    parts: list[Partition] = []
    for members in comps.values():
        parts.append(_analyze(graph, memo, members, referenced))
    # deterministic order (by smallest member id) for reproducible planning
    parts.sort(key=lambda p: min(p.nodes))
    return parts


def _analyze(graph: Graph, memo: MemoTable, members: set[int],
             referenced: set[int]) -> Partition:
    roots = sorted(nid for nid in members if nid not in referenced)

    inputs: set[int] = set()
    for nid in members:
        for inp in graph.by_id[nid].inputs:
            if inp.nid not in members:
                inputs.add(inp.nid)

    # materialization points: multiple consumers (graph-wide), not a root
    mat = sorted(nid for nid in members
                 if graph.n_consumers(nid) > 1 and nid not in roots)

    # nodes whose value escapes the partition (external consumer or output)
    exits: set[int] = set()
    for nid in members:
        if nid in graph.output_ids:
            exits.add(nid)
        for c in graph.consumers[nid]:
            if c not in members:
                exits.add(nid)

    points: list[Point] = []
    seen: set[Point] = set()
    # (a) materialization-point consumers, individually per dependency
    for m in mat:
        for c in graph.consumers[m]:
            if c in members and _references(memo, c, m):
                p = (c, m)
                if p not in seen:
                    seen.add(p)
                    points.append(p)
    # (b) template switches
    for nid in members:
        t_out = set(memo.distinct_types(nid))
        for inp in graph.by_id[nid].inputs:
            if inp.nid not in members or (nid, inp.nid) in seen:
                continue
            if not _references(memo, nid, inp.nid):
                continue
            t_in = set(memo.distinct_types(inp.nid))
            if t_in - t_out:
                p = (nid, inp.nid)
                seen.add(p)
                points.append(p)

    return Partition(nodes=members, roots=roots, inputs=inputs,
                     mat_points=mat, points=points, exits=exits)


def _references(memo: MemoTable, consumer: int, inp: int) -> bool:
    return any(inp in e.ref_ids() for e in memo.entries(consumer))
