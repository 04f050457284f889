"""MPSkipEnum — materialization-point skip enumeration (paper §4.4, Alg. 2).

Linearizes the 2^|M'| assignment space of a partition's interesting points
(MSB-first, negative→positive so plan 0 = maximal fusion = the fuse-all
opening heuristic, giving a good initial upper bound) and scans it with:

  * **cost-based pruning**: C̲(q) = static partition bound + minimum
    materialization cost of q; whenever C̲ ≥ C̄ (best so far), skip the
    2^(|M'|−x−1) plans that share the prefix up to the last true bit x —
    they only add materialization cost;
  * **structural pruning**: a cut set of interesting points that, when
    materialized, splits the remaining points into independent sub-problems
    S1/S2 solved recursively (2^|S1|+2^|S2| ≪ 2^(|S1|+|S2|)); cut sets are
    scored by Eq. (5) and the best one is laid out first in the search
    space;
  * **partial costing**: GETPLANCOST aborts once the running cost exceeds C̄.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

from .cost import (CostParams, mp_cost, partition_cost, static_lower_bound)
from .ir import Graph
from .memo import MemoTable
from .partitions import Partition, Point


@dataclass
class EnumStats:
    partitions: int = 0
    points_total: int = 0
    space_size: float = 0.0        # Σ 2^|M'_i| (unpruned space)
    plans_costed: int = 0
    plans_skipped_cost: float = 0.0
    plans_skipped_struct: float = 0.0
    cut_sets_used: int = 0


# -- reachability graph & cut sets -------------------------------------------

@dataclass
class CutSet:
    points_ix: list[int]           # indices into the point list
    s1_ix: list[int]
    s2_ix: list[int]
    score: float = 0.0


def _walk_points(graph: Graph, part: Partition, starts: Sequence[int],
                 blocked: set[int], points: Sequence[Point]) -> set[int]:
    """Indices of points whose dependency edge is traversed walking
    consumer→input from ``starts``, not descending below ``blocked`` nodes."""
    pidx: dict[Point, int] = {p: i for i, p in enumerate(points)}
    hit: set[int] = set()
    seen: set[int] = set()
    stack = [s for s in starts if s in part.nodes]
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        for inp in graph.by_id[c].inputs:
            t = inp.nid
            if (c, t) in pidx:
                hit.add(pidx[(c, t)])
            if t in part.nodes and t not in blocked:
                stack.append(t)
    return hit


def find_cut_sets(graph: Graph, part: Partition,
                  points: Sequence[Point]) -> list[CutSet]:
    """Candidate cut sets: per-target composites, single points, and
    non-overlapping pairs of composites; valid iff they split the remaining
    points into two non-empty disjoint halves (paper §4.4)."""
    n = len(points)
    by_target: dict[int, list[int]] = {}
    for i, (_, t) in enumerate(points):
        by_target.setdefault(t, []).append(i)

    composites = [tuple(ix) for ix in by_target.values()]
    candidates: list[tuple[tuple[int, ...], set[int]]] = []
    for ix in composites:
        candidates.append((ix, {points[i][1] for i in ix}))
    for a in range(len(composites)):
        for b in range(a + 1, len(composites)):
            ix = tuple(composites[a]) + tuple(composites[b])
            if len(ix) < n:
                candidates.append(
                    (ix, {points[i][1] for i in ix}))

    roots = list(set(part.roots) | part.exits)
    out: list[CutSet] = []
    for ix, targets in candidates:
        rest = [i for i in range(n) if i not in ix]
        if not rest:
            continue
        s1 = _walk_points(graph, part, roots, targets, points) - set(ix)
        s2 = _walk_points(graph, part, list(targets), set(), points) - set(ix)
        if not s1 or not s2 or (s1 & s2):
            continue
        # points in neither side (disconnected siblings) join S1
        s1 |= set(rest) - s1 - s2
        score = ((2 ** len(ix) - 1) / 2 ** len(ix) * 2 ** n
                 + (2 ** len(s1) + 2 ** len(s2)) / 2 ** len(ix))   # Eq. (5)
        out.append(CutSet(list(ix), sorted(s1), sorted(s2), score))
    out.sort(key=lambda c: c.score)
    return out


# -- the enumeration algorithm -------------------------------------------------

#: partitions above this many interesting points skip exact enumeration and
#: use greedy local search instead.  The paper's forward DAGs stay well
#: under this; planned *gradient* DAGs (repro_torch.core.grad) can exceed it —
#: 2^|M'| scanning is intractable there and any assignment is numerically
#: exact, so bounded search only trades plan cost, never correctness.
EXACT_ENUM_MAX_POINTS = 16


def _greedy_enum(graph: Graph, memo: MemoTable, part: Partition,
                 params: CostParams, pts: list[Point],
                 st: EnumStats) -> tuple[tuple[bool, ...], float]:
    """First-improvement local search over materialization assignments:
    start from maximal fusion (the opening heuristic) and flip single
    points while it pays, a bounded number of passes."""
    n = len(pts)
    q = [False] * n
    best = partition_cost(graph, memo, part, set(), params)
    st.plans_costed += 1
    for _ in range(3):                       # bounded improvement passes
        improved = False
        for i in range(n):
            q[i] = not q[i]
            banned = {pts[k] for k in range(n) if q[k]}
            c = partition_cost(graph, memo, part, banned, params, ub=best)
            st.plans_costed += 1
            if c < best:
                best, improved = c, True
            else:
                q[i] = not q[i]
        if not improved:
            break
    return tuple(q), best


def mp_skip_enum(graph: Graph, memo: MemoTable, part: Partition,
                 params: CostParams, points: Optional[list[Point]] = None,
                 use_structural: bool = True,
                 use_cost_pruning: bool = True,
                 stats: Optional[EnumStats] = None) -> tuple[tuple[bool, ...], float]:
    """Return (q*, cost) for the partition's interesting points."""
    st = stats if stats is not None else EnumStats()
    pts = list(part.points if points is None else points)
    n = len(pts)
    if n > EXACT_ENUM_MAX_POINTS:
        # pts is in caller order here (no cut-set reordering happened yet)
        return _greedy_enum(graph, memo, part, params, pts, st)
    if n == 0:
        c = partition_cost(graph, memo, part, set(), params)
        st.plans_costed += 1
        return (), c

    # structural layout: best cut set first (paper sorts by Eq. 5 and lays
    # out the search space accordingly)
    cut: Optional[CutSet] = None
    if use_structural and n >= 3:
        cuts = find_cut_sets(graph, part, pts)
        if cuts:
            cut = cuts[0]
            order = (list(cut.points_ix)
                     + [i for i in range(n) if i not in cut.points_ix])
            pts = [pts[i] for i in order]
            remap = {old: new for new, old in enumerate(order)}
            cut = CutSet([remap[i] for i in cut.points_ix],
                         [remap[i] for i in cut.s1_ix],
                         [remap[i] for i in cut.s2_ix], cut.score)

    static_lb = static_lower_bound(graph, memo, part, params)
    written_anyway = frozenset(set(part.roots) | part.exits)

    best_q: Optional[tuple[bool, ...]] = None
    best_c = math.inf
    total = 1 << n
    j = 0
    while j < total:
        q = tuple(bool(j >> (n - 1 - i) & 1) for i in range(n))
        pskip = 0
        # -- structural pruning via skip-ahead (lines 6-10) -------------------
        if cut is not None and _is_cut_entry(q, cut, n):
            q = list(q)
            for sub_ix in (cut.s1_ix, cut.s2_ix):
                if not sub_ix:
                    continue
                sub_pts = [pts[i] for i in sub_ix]
                sub_q, _ = mp_skip_enum(graph, memo, part, params,
                                        points=sub_pts,
                                        use_structural=False,
                                        use_cost_pruning=use_cost_pruning,
                                        stats=st)
                for i, v in zip(sub_ix, sub_q):
                    q[i] = v
            q = tuple(q)
            pskip = (1 << (n - len(cut.points_ix))) - 1
            st.plans_skipped_struct += pskip
            st.cut_sets_used += 1
        banned = {pts[i] for i in range(n) if q[i]}
        # -- cost-based pruning (lines 11-15) ----------------------------------
        if use_cost_pruning and pskip == 0:
            lb = static_lb + mp_cost(graph, banned, params, written_anyway)
            if lb >= best_c:
                x = _last_true(q)
                skip = (1 << (n - 1 - x)) if x >= 0 else total - j
                st.plans_skipped_cost += skip - 1
                j += skip
                continue
        # -- plan costing and comparison (lines 16-19) ---------------------------
        c = partition_cost(graph, memo, part, banned, params, ub=best_c)
        st.plans_costed += 1
        if best_q is None or c < best_c:
            best_q, best_c = q, c
        j += 1 + pskip

    # translate back to the caller's point order
    if points is None and best_q is not None:
        order_map = {p: v for p, v in zip(pts, best_q)}
        best_q = tuple(order_map[p] for p in part.points)
    return best_q if best_q is not None else tuple([False] * n), best_c


def _is_cut_entry(q: tuple[bool, ...], cut: CutSet, n: int) -> bool:
    """True at the single assignment where the cut set is all-true and every
    remaining point is false — the entry of the decomposable subspace."""
    cs = set(cut.points_ix)
    return all(q[i] for i in cs) and not any(q[i] for i in range(n)
                                             if i not in cs)


def _last_true(q: tuple[bool, ...]) -> int:
    for i in range(len(q) - 1, -1, -1):
        if q[i]:
            return i
    return -1
