"""Candidate exploration — the OFMC algorithm (paper §3.2, Algorithm 1).

A single bottom-up, depth-first pass over the HOP DAG populates the memo
table with all valid partial fusion plans.  Template-oblivious: all
template-specific logic lives behind the open/fuse/merge/close predicates in
:mod:`templates`.  Linear in the number of operators (memoized); per
operator at most O(2^|inputs| · |T|) entries.

Placement-oblivious too: the same memo entries serve both execution arms
of the ``local × distributed`` dimension.  A distributed variant of a
template changes *where* the generated body runs and which collective
epilogue closes it (:data:`repro_torch.core.templates.DIST_VARIANTS`), not
which fusion structures are valid — so exploration enumerates structure
once, and selection (:mod:`repro_torch.core.select` / :func:`repro_torch.core.cost.
spec_cost`) prices each surviving candidate on both arms when a mesh
layout is in scope.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

from .ir import Graph, Node
from .memo import MemoEntry, MemoTable
from .templates import TEMPLATES, Status, Template


@dataclass
class ExploreStats:
    operators: int = 0
    entries_created: int = 0
    entries_kept: int = 0
    opens: int = 0
    fuses: int = 0


def explore(graph: Graph, *, prune_dominated: bool = False,
            stats: ExploreStats | None = None) -> MemoTable:
    """Populate a memo table for ``graph`` (Algorithm 1 driver)."""
    memo = MemoTable()
    st = stats if stats is not None else ExploreStats()
    for out in graph.outputs:
        _ofmc_explore(out, graph, memo, st)
    if prune_dominated:
        single = _single_consumer_ids(graph)
        for nid in list(memo.groups()):
            memo.prune_dominated(nid, single)
    return memo


def _single_consumer_ids(graph: Graph) -> set[int]:
    return {nid for nid in graph.by_id if graph.n_consumers(nid) <= 1}


def _ofmc_explore(h: Node, graph: Graph, memo: MemoTable,
                  st: ExploreStats) -> None:
    # -- memoization of processed operators (lines 1-3) ---------------------
    if memo.processed(h.nid):
        return
    # -- recursive candidate exploration (lines 4-6) -------------------------
    for gin in h.inputs:
        _ofmc_explore(gin, graph, memo, st)
    if h.is_input:
        memo.mark_processed(h.nid)
        return
    st.operators += 1

    entries: list[MemoEntry] = []
    # -- open initial operator plans (lines 7-10) -----------------------------
    for t in TEMPLATES.values():
        if t.open(h):
            st.opens += 1
            entries.extend(_create_plans(h, None, t, memo))
    # -- fuse and merge operator plans (lines 11-15) ---------------------------
    for j, gin in enumerate(h.inputs):
        for tt in memo.distinct_types(gin.nid):
            t = TEMPLATES[tt]
            if memo.has_open(gin.nid, tt) and t.fuse(h, gin):
                st.fuses += 1
                entries.extend(_create_plans(h, j, t, memo))
    st.entries_created += len(entries)

    # -- close operator plans (lines 16-20) -------------------------------------
    kept: list[MemoEntry] = []
    for e in entries:
        status = TEMPLATES[e.ttype].close(h, graph)
        if status == Status.CLOSED_INVALID:
            continue
        kept.append(e.with_status(status))
    memo.add_all(h.nid, kept)

    # -- prune redundant plans and memoize (lines 21-24) --------------------------
    memo.prune_redundant(h.nid, len(h.inputs))
    st.entries_kept += len(memo.entries(h.nid))
    memo.mark_processed(h.nid)


def _create_plans(h: Node, fuse_j: int | None, t: Template,
                  memo: MemoTable) -> list[MemoEntry]:
    """CREATEPLANS (paper §3.2): build entries for the fused operator at h
    under template t, enumerating all *local* input combinations that satisfy
    the pair-wise merge condition.  ``fuse_j`` (if given) is the input whose
    open plan triggered the fuse — it is always referenced."""
    n = len(h.inputs)
    fusable: list[bool] = []
    for j, gin in enumerate(h.inputs):
        if gin.is_input:
            fusable.append(False)            # leaves have no groups
        elif j == fuse_j:
            fusable.append(True)
        else:
            fusable.append(t.merge(h, gin)
                           and memo.has_compatible_open(gin.nid, t.ttype))
    cand = [j for j in range(n) if fusable[j] and j != fuse_j]

    entries: list[MemoEntry] = []
    for k in range(len(cand) + 1):
        for sub in combinations(cand, k):
            chosen = set(sub)
            if fuse_j is not None:
                chosen.add(fuse_j)
            refs = tuple(h.inputs[j].nid if j in chosen else -1
                         for j in range(n))
            entries.append(MemoEntry(t.ttype, refs))
    return entries
