"""The memoization table of partial fusion plans (paper §3.1).

Groups (one per operator / logical subexpression, keyed by node id) hold
memo entries ``(template-type, input-refs, status)``.  ``refs`` aligns with
the hop's inputs by position; each element is the input's node id (a *group
reference* — fuse) or ``-1`` (materialized intermediate).  A reference from
an entry to a group implies the group contains at least one compatible plan
(enforced by exploration).

Mirrors Cascades groups/group-expressions in spirit, but — like the paper —
is used purely as a compact fusion-plan representation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

from .templates import COMPAT, Status, TType


@dataclass(frozen=True)
class MemoEntry:
    ttype: TType
    refs: tuple[int, ...]
    status: Status = Status.OPEN_VALID

    @property
    def closed(self) -> bool:
        return self.status in (Status.CLOSED_VALID, Status.CLOSED_INVALID)

    @property
    def can_root(self) -> bool:
        return self.status in (Status.OPEN_VALID, Status.CLOSED_VALID)

    def ref_ids(self) -> tuple[int, ...]:
        return tuple(r for r in self.refs if r >= 0)

    @property
    def n_refs(self) -> int:
        return sum(1 for r in self.refs if r >= 0)

    def with_status(self, status: Status) -> "MemoEntry":
        return MemoEntry(self.ttype, self.refs, status)

    def __repr__(self) -> str:  # matches the paper's R(10,9) notation
        body = ",".join(str(r) for r in self.refs)
        suffix = {Status.OPEN_VALID: "", Status.OPEN_INVALID: "!",
                  Status.CLOSED_VALID: "*", Status.CLOSED_INVALID: "x"}
        return f"{self.ttype.letter}({body}){suffix[self.status]}"


class MemoTable:
    def __init__(self) -> None:
        self._groups: dict[int, list[MemoEntry]] = {}
        self._processed: set[int] = set()        # the paper's W[*]

    # -- population ----------------------------------------------------------
    def add_all(self, nid: int, entries: Iterable[MemoEntry]) -> None:
        self._groups.setdefault(nid, []).extend(entries)

    def set_entries(self, nid: int, entries: list[MemoEntry]) -> None:
        if entries:
            self._groups[nid] = entries
        else:
            self._groups.pop(nid, None)

    def mark_processed(self, nid: int) -> None:
        self._processed.add(nid)

    # -- queries --------------------------------------------------------------
    def processed(self, nid: int) -> bool:
        return nid in self._processed

    def contains(self, nid: int) -> bool:
        return nid in self._groups and bool(self._groups[nid])

    def entries(self, nid: int) -> list[MemoEntry]:
        return self._groups.get(nid, [])

    def groups(self) -> Iterator[int]:
        return iter(self._groups)

    def distinct_types(self, nid: int) -> list[TType]:
        seen: list[TType] = []
        for e in self.entries(nid):
            if e.ttype not in seen:
                seen.append(e.ttype)
        return seen

    def has_open(self, nid: int, ttype: TType) -> bool:
        """Open (extendable) entry of exactly this type in group nid?"""
        return any(e.ttype == ttype and not e.closed
                   for e in self.entries(nid))

    def has_compatible_open(self, nid: int, ttype: TType) -> bool:
        """Open entry that may continue a fused operator of type ``ttype``
        when reached through a reference (same type or mergeable, Cell→Row)."""
        compat = COMPAT[ttype]
        return any(e.ttype in compat and not e.closed
                   for e in self.entries(nid))

    def best_compatible(self, nid: int, ttype: Optional[TType],
                        banned_refs: Optional[set[tuple[int, int]]] = None
                        ) -> Optional[MemoEntry]:
        """Pick the continuation entry with the most fusion references (the
        paper probes "the best fusion plan regarding template type and
        fusion references" during top-down costing).

        ``ttype is None`` → selecting a plan *root* (must be can_root);
        otherwise → interior continuation (must be open & compatible).
        ``banned_refs`` = interesting-point assignments: (src, dst) data
        dependencies forced to materialize; entries using them are invalid.
        """
        if ttype is None:
            cands = [e for e in self.entries(nid) if e.can_root]
        else:
            compat = COMPAT[ttype]
            cands = [e for e in self.entries(nid)
                     if e.ttype in compat and not e.closed]
        if banned_refs:
            cands = [e for e in cands
                     if not any((nid, r) in banned_refs for r in e.ref_ids())]
        if not cands:
            return None
        return max(cands, key=lambda e: ((e.ttype == ttype) if ttype else 0,
                                         e.n_refs, -int(e.ttype)))

    # -- pruning (paper §3.2) --------------------------------------------------
    def prune_redundant(self, nid: int, n_op_inputs: int) -> None:
        """Drop duplicates and closed-valid single-operator entries (a fused
        operator covering one op gains nothing — e.g. no C(-1) at rowSums)."""
        out: list[MemoEntry] = []
        seen: set[tuple] = set()
        for e in self.entries(nid):
            if e.status == Status.CLOSED_INVALID:
                continue
            if e.status == Status.CLOSED_VALID and e.n_refs == 0:
                continue
            k = (e.ttype, e.refs, e.status)
            if k in seen:
                continue
            seen.add(k)
            out.append(e)
        self.set_entries(nid, out)

    def prune_dominated(self, nid: int, single_consumer: set[int]) -> None:
        """Heuristic-only dominance pruning: an entry is dominated if all its
        refs point to once-consumed operators and another same-type entry's
        ref set is a strict superset (paper §3.2 example: R(10,9) dominates
        R(10,-1))."""
        entries = self.entries(nid)
        keep: list[MemoEntry] = []
        for e in entries:
            refs_e = set(e.ref_ids())
            dominated = False
            if all(r in single_consumer for r in refs_e):
                for o in entries:
                    if o is e or o.ttype != e.ttype:
                        continue
                    refs_o = set(o.ref_ids())
                    if refs_e < refs_o:
                        dominated = True
                        break
            if not dominated:
                keep.append(e)
        self.set_entries(nid, keep)

    # -- stats / debug -----------------------------------------------------------
    def n_entries(self) -> int:
        return sum(len(v) for v in self._groups.values())

    def __repr__(self) -> str:  # pragma: no cover
        lines = []
        for nid in sorted(self._groups):
            lines.append(f"{nid}: " + " ".join(map(repr, self._groups[nid])))
        return "\n".join(lines)
