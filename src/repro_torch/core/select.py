"""Candidate selection driver (paper §4): chooses the optimal, non-conflicting
set of fusion plans per HOP DAG and induces the runtime plan.

Modes mirror the paper's experimental arms:
  * ``gen``  — cost-based MPSkipEnum per partition (the contribution),
  * ``fa``   — fuse-all heuristic (maximal fusion, redundant CSE compute),
  * ``fnr``  — fuse-no-redundancy (materialize every multi-consumer
               intermediate),
  * ``none`` — no fusion at all (Base): every operator basic.

Multi-aggregate combining: selected MAgg-rooted fused operators that share
at least one input merge into a single multi-output fused operator (paper
§5.2: "Gen compiles a multi-aggregate with a 2×1 output matrix"), dedup-ing
their shared scans.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch import hw as _hw
from .cost import (CostParams, FusedOpSpec, Placement, TPU_V5E, node_bytes,
                   resolve_partition, row_partitioned, spec_cost,
                   spec_placement)
from .enumerate import EnumStats, mp_skip_enum
from .explore import ExploreStats, explore
from .ir import Graph
from .memo import MemoTable
from .partitions import (Partition, PlanInvariantError, Point,
                         build_partitions)
from .templates import TType

_EPILOGUES = ("none", "psum", "pmin", "pmax")

MODES = ("gen", "fa", "fnr", "none")


@dataclass
class MultiAggSpec:
    """k combined full aggregates sharing a single scan of their inputs."""
    roots: list[int]
    parts: list[FusedOpSpec]
    inputs: list[int]
    #: local/distributed decision (see :class:`repro_torch.core.cost.Placement`)
    placement: Optional[Placement] = None

    root = property(lambda self: self.roots[0])
    ttype = TType.MAGG
    fused = True
    driver = None


@dataclass(frozen=True)
class Segment:
    """A maximal run of adjacent distributed-placed operators that
    executes inside a single ``shard_map`` region: intra-segment
    row-partitioned intermediates flow shard-to-shard instead of being
    gathered and re-scattered at every operator boundary."""

    indices: tuple[int, ...]       # positions in ExecPlan.specs, in order
    axes: tuple[str, ...]          # row-shard mesh axes
    n: int                         # row-shard degree
    #: (producer spec idx, consumer spec idx, nid) row-sharded edges
    sharded_edges: tuple[tuple[int, int, int], ...]
    #: boundary all-gather volume the fused region removes (bytes): one
    #: ring all-gather of each row-sharded intra-segment intermediate
    removed_gather_bytes: float


@dataclass
class ExecPlan:
    graph: Graph
    specs: list          # FusedOpSpec | MultiAggSpec, dependency order
    cost: float
    memo: Optional[MemoTable] = None
    enum_stats: Optional[EnumStats] = None
    explore_stats: Optional[ExploreStats] = None
    #: contiguous distributed runs (see :class:`Segment`); empty when the
    #: plan was selected without distributed geometry
    segments: tuple = ()
    #: cost parameters the plan was selected under — the verifier replays
    #: placement/segment derivations and constraint checks against these
    params: Optional[CostParams] = None
    #: winning rewrite-rule chain (:mod:`repro_torch.core.rewrite` labels, e.g.
    #: ``("spores_rotate@7",)``) when this plan was selected for a rewritten
    #: variant of the traced DAG; () for the DAG as written.  Part of the
    #: whole-plan cache key (:func:`repro_torch.core.codegen.staged_plan_key`).
    rewrite: tuple = ()

    def fused_specs(self) -> list:
        return [s for s in self.specs if getattr(s, "fused", False)]


def select(graph: Graph, memo: MemoTable, mode: str = "gen",
           params: CostParams = TPU_V5E,
           enum_stats: Optional[EnumStats] = None) -> tuple[list, float]:
    """Run selection, returning (specs in dependency order, total cost)."""
    assert mode in MODES, mode
    st = enum_stats if enum_stats is not None else EnumStats()
    parts = build_partitions(graph, memo) if mode != "none" else []

    specs: list = []
    covered: set[int] = set()
    produced: set[int] = set()
    total_cost = 0.0
    for part in parts:
        st.partitions += 1
        st.points_total += len(part.points)
        st.space_size += 2 ** len(part.points)
        banned = _assignment(graph, memo, part, mode, params, st)
        probe = "greedy" if mode in ("fa", "fnr") else "cost"
        part_specs = resolve_partition(graph, memo, part, banned, params,
                                       probe=probe)
        total_cost += sum(spec_cost(graph, s, params) for s in part_specs)
        for s in part_specs:
            specs.append(s)
            produced.add(s.root)
            covered.update(s.cover)

    # demand-driven fill-in: basic operators for every node that some spec
    # (or the graph outputs) reads but no partition plan produces.  Nodes
    # covered inside fused operators and consumed only there need nothing.
    demanded: list[int] = list(graph.output_ids)
    for s in specs:
        demanded.extend(s.inputs)
    while demanded:
        nid = demanded.pop()
        node = graph.by_id[nid]
        if nid in produced or node.is_input:
            continue
        spec = FusedOpSpec(nid, None, {nid: None},
                           [i.nid for i in node.inputs])
        specs.append(spec)
        produced.add(nid)
        total_cost += spec_cost(graph, spec, params)
        demanded.extend(i.nid for i in node.inputs)

    specs = _topo_order(graph, specs)
    specs = _combine_multi_aggs(graph, specs, params)
    if params.dist is not None and params.dist.n > 1:
        # re-walk the final plan in dependency order: pin placements with
        # chain-aware pricing and make that walk the authoritative plan
        # cost (the executed plan is the costed plan)
        total_cost = _annotate_placements(graph, specs, params)
    return specs, total_cost


def plan(graph: Graph, mode: str = "gen", params: CostParams = TPU_V5E,
         prune_dominated: Optional[bool] = None) -> ExecPlan:
    """Explore + select in one call (the paper's codegen compiler steps 1-2)."""
    if mode == "none":
        memo = MemoTable()
        ex_st = ExploreStats()
    else:
        ex_st = ExploreStats()
        dom = prune_dominated if prune_dominated is not None else mode in ("fa", "fnr")
        memo = explore(graph, prune_dominated=dom, stats=ex_st)
    en_st = EnumStats()
    specs, cost = select(graph, memo, mode, params, enum_stats=en_st)
    segments = annotate_segments(graph, specs, params)
    return ExecPlan(graph, specs, cost, memo, en_st, ex_st,
                    segments=segments, params=params)


# -- assignment policies -----------------------------------------------------

def _assignment(graph: Graph, memo: MemoTable, part: Partition, mode: str,
                params: CostParams, st: EnumStats) -> set[Point]:
    if mode == "fa" or not part.points:
        if mode == "gen" and not part.points:
            st.plans_costed += 1
        return set()                       # maximal fusion
    if mode == "fnr":
        # materialize every multi-consumer intermediate
        mat = set(part.mat_points)
        return {p for p in part.points if p[1] in mat}
    q, _ = mp_skip_enum(graph, memo, part, params, stats=st)
    return {p for p, v in zip(part.points, q) if v}


# -- local/distributed placement (hybrid plans) --------------------------------

def resolved_placements(graph: Graph, specs: list, params: CostParams
                        ) -> tuple[list, float]:
    """The authoritative local-vs-distributed walk, as a pure function:
    returns ``(placements, total cost)`` with one
    :class:`~repro_torch.core.cost.Placement` (or None, for basic operators)
    per spec, **without** mutating the specs.  Walks the plan in
    dependency order threading the interior-producer state (a
    row-partitioned intermediate anchors its distributed consumers and
    charges local ones the boundary gather).

    A combined multi-aggregate distributes only when *every* member
    aggregate does (all sum-reduced partials ride one ``psum`` of the
    stacked (k, 1) output); a single local member keeps the whole
    operator local rather than splitting one scan across arms.  Raises
    :class:`~repro_torch.core.partitions.PlanInvariantError` when the members'
    distributed placements disagree on the row-shard group — one scan
    cannot straddle two shard geometries.

    Also the plan verifier's replay (`SEL014`): re-running this walk over
    a plan's specs must reproduce the pinned placements exactly."""
    interior: dict[int, bool] = {}
    placements: list = []
    total = 0.0
    for s in specs:
        if isinstance(s, MultiAggSpec):
            pls = [spec_placement(graph, p, params, interior)
                   for p in s.parts]
            if pls and all(p.arm == "distributed" and p.epilogue == "psum"
                           for p in pls):
                n = pls[0].n
                if any((p.axes, p.n) != (pls[0].axes, n) for p in pls):
                    raise PlanInvariantError(
                        f"multi-aggregate %{s.root}: member placements "
                        f"disagree on the row-shard group "
                        f"{sorted({(p.axes, p.n) for p in pls})} — one "
                        f"combined scan cannot straddle shard geometries")
                out_b = len(s.roots) * params.dtype_bytes
                gather = sum(p.gather_bytes for p in pls)
                coll = gather + _hw.all_reduce_bytes(out_b, n)
                sharded = frozenset().union(*(p.sharded for p in pls))
                pl = Placement(
                    "distributed", sum(p.cost for p in pls),
                    sum(p.local_cost for p in pls),
                    sum(p.dist_cost for p in pls), "psum",
                    pls[0].axes, n, coll, gather, sharded)
            else:
                # keep the per-part distributed evidence: a finite
                # dist_cost here means "possible but not chosen", which
                # is what explain() debugging needs to see
                local = sum(p.local_cost for p in pls) if pls else 0.0
                dist = sum(p.dist_cost for p in pls) if pls else math.inf
                pl = Placement("local", local, local, dist)
            placements.append(pl)
            total += pl.cost
            for r in s.roots:
                interior[r] = False       # psum output is replicated
        elif getattr(s, "fused", False):
            pl = spec_placement(graph, s, params, interior)
            placements.append(pl)
            total += pl.cost
            interior[s.root] = row_partitioned(pl)
        else:
            placements.append(None)
            total += spec_cost(graph, s, params, interior)
    return placements, total


def _annotate_placements(graph: Graph, specs: list,
                         params: CostParams) -> float:
    """Pin the local-vs-distributed decision :func:`spec_cost` already
    priced onto every fused operator, so codegen executes — and
    ``explain()`` reports — exactly the costed arm.  Returns the
    resulting total plan cost (see :func:`resolved_placements`)."""
    placements, total = resolved_placements(graph, specs, params)
    for s, pl in zip(specs, placements):
        if pl is not None:
            s.placement = pl
    return total


def annotate_segments(graph: Graph, specs: list,
                      params: CostParams) -> tuple:
    """Group maximal runs of *adjacent* distributed-placed operators into
    :class:`Segment`\\ s — the units codegen lowers into a single
    ``shard_map`` region.

    Two consecutive distributed specs stay in one run when they share the
    row-shard group (axes, n) and their data flow is representable inside
    one region: a value produced row-partitioned in the run (``"none"``
    epilogue) must be read as a row shard by every in-run consumer, a
    reduced value (replicated after its collective) must be read
    broadcast, and an external operand consumed by several run members
    must be sharded for all of them or none.  Violations split the run —
    correctness over region length.

    Raises :class:`~repro_torch.core.partitions.PlanInvariantError` when a
    spec's placement is not even internally consistent — an unknown
    collective epilogue, a sharded operand the spec does not bind, or two
    specs producing the same value: splitting runs cannot repair those,
    and lowering them would compute garbage."""
    if params.dist is None or params.dist.n <= 1:
        return ()
    segments: list[Segment] = []
    run: list[int] = []

    def roots_of(s) -> tuple[int, ...]:
        return tuple(s.roots) if isinstance(s, MultiAggSpec) else (s.root,)

    roots_seen: dict[int, int] = {}
    for idx, s in enumerate(specs):
        for r in roots_of(s):
            if r in roots_seen:
                raise PlanInvariantError(
                    f"value %{r} is produced by both spec "
                    f"[{roots_seen[r]}] and spec[{idx}] — segment "
                    f"grouping needs a single producer per value")
            roots_seen[r] = idx
        pl = getattr(s, "placement", None)
        if pl is None or pl.arm != "distributed":
            continue
        if pl.epilogue not in _EPILOGUES:
            raise PlanInvariantError(
                f"spec[{idx}] (root %{s.root}) has unknown collective "
                f"epilogue {pl.epilogue!r}; expected one of "
                f"{_EPILOGUES}")
        extra = set(pl.sharded) - set(s.inputs)
        if extra:
            raise PlanInvariantError(
                f"spec[{idx}] (root %{s.root}) placement marks "
                f"{sorted(extra)} row-sharded but the spec does not "
                f"bind them — placement and binding drifted apart")

    def compatible(idx: int) -> bool:
        s = specs[idx]
        pl = s.placement
        head = specs[run[0]].placement
        if pl.axes != head.axes or pl.n != head.n:
            return False
        produced = {r: specs[j].placement.epilogue
                    for j in run for r in roots_of(specs[j])}
        for i in s.inputs:
            epil = produced.get(i)
            if epil == "none" and i not in pl.sharded:
                return False          # would need an in-region gather
            if epil is not None and epil != "none" and i in pl.sharded:
                return False          # replicated value read as a shard
            if epil is None:          # shared external operand: one view
                for j in run:
                    pj = specs[j].placement
                    if i in specs[j].inputs and \
                            (i in pj.sharded) != (i in pl.sharded):
                        return False
        return True

    def flush() -> None:
        if len(run) >= 2:
            head = specs[run[0]].placement
            produced = {r: (j, specs[j].placement.epilogue)
                        for j in run for r in roots_of(specs[j])}
            edges = []
            saved = 0.0
            for c in run:
                for i in specs[c].inputs:
                    hit = produced.get(i)
                    if hit is not None and hit[1] == "none" \
                            and i in specs[c].placement.sharded:
                        edges.append((hit[0], c, i))
                        saved += _hw.all_gather_bytes(
                            node_bytes(graph.by_id[i], params), head.n)
            segments.append(Segment(tuple(run), head.axes, head.n,
                                    tuple(edges), saved))
        run.clear()

    for idx, s in enumerate(specs):
        pl = getattr(s, "placement", None)
        if pl is None or pl.arm != "distributed":
            flush()
            continue
        if run and not compatible(idx):
            flush()
        run.append(idx)
    flush()
    return tuple(segments)


# -- helpers -------------------------------------------------------------------

def _topo_order(graph: Graph, specs: list) -> list:
    pos = {n.nid: i for i, n in enumerate(graph.nodes)}
    return sorted(specs, key=lambda s: pos[s.root])


def _combine_multi_aggs(graph: Graph, specs: list,
                        params: CostParams) -> list:
    """Greedily merge MAgg fused ops sharing ≥1 input and a common main
    shape into multi-output fused operators."""
    groups: list[list[FusedOpSpec]] = []
    rest: list = []
    for s in specs:
        if isinstance(s, FusedOpSpec) and s.ttype == TType.MAGG and s.fused:
            placed = False
            for g in groups:
                if (set(g[0].inputs) & set(s.inputs)
                        and _main_shape(graph, g[0]) == _main_shape(graph, s)
                        and len(g) < 4):
                    g.append(s)
                    placed = True
                    break
            if not placed:
                groups.append([s])
        else:
            rest.append(s)

    out: list = list(rest)
    for g in groups:
        if len(g) == 1:
            out.append(g[0])
        else:
            inputs: list[int] = []
            for s in g:
                for i in s.inputs:
                    if i not in inputs:
                        inputs.append(i)
            out.append(MultiAggSpec([s.root for s in g], g, inputs))
    return _topo_order(graph, out)


def _main_shape(graph: Graph, spec: FusedOpSpec) -> tuple[int, int]:
    shapes = [graph.by_id[i].shape for i in spec.inputs
              if not graph.by_id[i].is_scalar]
    if not shapes:
        return (1, 1)
    return max(shapes, key=lambda s: s[0] * s[1])
