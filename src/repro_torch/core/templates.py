"""Fusion templates and their OFMC (open-fuse-merge-close) predicates.

Paper Table 1 / §3.2: four template types — **Cell**, **Row**, **MAgg**,
**Outer** — each a generic fused-operator skeleton with a data binding.  The
OFMC abstraction separates template-specific conditions from DAG traversal:

  - ``open(h)``   may a new fused operator of this template start at hop h?
  - ``fuse(h,in)``may an open fused op at input ``in`` expand to consumer h?
  - ``merge(h,in)``may an open fused op at h merge fused ops at input ``in``?
  - ``close(h)``  status after h: OPEN / CLOSED_VALID / CLOSED_INVALID
                  (+ OPEN_INVALID: extendable but not a valid plan root).

TPU adaptation constants: ``NARROW_MAX`` (a Row-template matmul side operand
must fit a VMEM row panel and feed the VPU/MXU without a grid over columns —
128-lane aligned) and ``OUTER_RANK_MAX`` (Outer-template rank bound so a
U-row/V-row panel pair fits VMEM), replacing the paper's CPU blocksize B_c.
"""

from __future__ import annotations

import enum
from typing import Optional

from .ir import Graph, Node, sparse_safe_wrt

# thresholds (TPU-motivated; see module docstring)
NARROW_MAX = 256          # max cols of a Row-template matmul side operand
OUTER_RANK_MAX = 512      # max common dim k of an outer-product matmul
OUTER_MIN_DIM = 128       # outer product ≥ one MXU block per side


class TType(enum.IntEnum):
    CELL = 0
    ROW = 1
    MAGG = 2
    OUTER = 3

    @property
    def letter(self) -> str:
        return "CRMO"[int(self)]


class Status(enum.IntEnum):
    OPEN_VALID = 0       # extendable, may root a plan
    OPEN_INVALID = 1     # extendable, may NOT root a plan (paper §3.1)
    CLOSED_VALID = 2     # complete fused operator
    CLOSED_INVALID = 3   # removed from the memo table


#: interior-reference compatibility: following a ref from an entry of type t
#: into a group, which entry types may continue the fused operator (paper:
#: "merge of Cell templates into Row templates", Outer merges Cell, …).
COMPAT: dict[TType, tuple[TType, ...]] = {
    TType.CELL: (TType.CELL,),
    TType.ROW: (TType.ROW, TType.CELL),
    TType.MAGG: (TType.CELL, TType.MAGG),
    TType.OUTER: (TType.OUTER, TType.CELL),
}


def _is_full_agg(h: Node) -> bool:
    return h.is_agg and h.agg_axis == "full"


def _row_compatible_shapes(h: Node) -> bool:
    """Cell-wise op whose operands broadcast row-wise: full matrices of equal
    rows, (m,1) per-row scalars, (1,n) shared row vectors, or scalars."""
    mats = [i for i in h.inputs if not i.is_scalar]
    if not mats:
        return False
    rows = {i.shape[0] for i in mats if i.shape[0] != 1}
    return len(rows) <= 1


def _narrow_mm(h: Node) -> bool:
    """Matrix multiplication with a narrow output (matrix-vector or
    matrix–narrow-matrix chain — the Row template's bread and butter).

    A double-transposed product t(A) @ t(B) is excluded: neither Row
    skeleton closes it (col_t_agg contracts t(X) @ chain, no_agg runs the
    chain's rows through (chain) @ B), so it executes as a basic operator
    instead of silently dropping one transpose inside a fused cover."""
    if not h.is_matmul:
        return False
    if h.ta and h.tb:
        return False
    m, k, n = h.mm_dims()
    return n <= NARROW_MAX and k > 1 and m > 1


def _outer_mm(h: Node) -> bool:
    """Outer-product-like matmul U @ t(V): large m×n output, small k."""
    if not h.is_matmul:
        return False
    m, k, n = h.mm_dims()
    return (k <= OUTER_RANK_MAX and m >= OUTER_MIN_DIM and n >= OUTER_MIN_DIM
            and m > k and n > k)


class Template:
    ttype: TType

    def open(self, h: Node) -> bool:
        raise NotImplementedError

    def fuse(self, h: Node, inp: Node) -> bool:
        raise NotImplementedError

    def merge(self, h: Node, inp: Node) -> bool:
        raise NotImplementedError

    def close(self, h: Node, graph: Graph) -> Status:
        raise NotImplementedError


# --------------------------------------------------------------------------
class CellTpl(Template):
    """Cell-wise template: binds cells X_ij, side inputs, scalars.
    Variants no_agg / row_agg / col_agg / full_agg (paper Table 1)."""

    ttype = TType.CELL

    def open(self, h: Node) -> bool:
        # idx (column-range read) is a valid entry: fusing it lets consumers
        # read the base matrix with an offset instead of materializing the
        # slice (SystemML fuses right-indexing into all templates).
        return (h.is_cellwise or h.op == "idx") and not h.is_scalar

    def fuse(self, h: Node, inp: Node) -> bool:
        if h.is_cellwise or h.op == "idx":
            return True
        if h.is_agg:            # any aggregation fuses (and then closes)
            return True
        return False

    def merge(self, h: Node, inp: Node) -> bool:
        # cell ops merge cell plans at any (broadcast-compatible) input
        return h.is_cellwise or h.is_agg or h.op == "idx"

    def close(self, h: Node, graph: Graph) -> Status:
        if h.is_agg:            # paper: "any aggregation closes a Cell"
            return Status.CLOSED_VALID
        return Status.OPEN_VALID


# --------------------------------------------------------------------------
class RowTpl(Template):
    """Row-wise template: binds rows X_i with side inputs/scalars.  Covers
    matvec chains (Xv, Xᵀy, XV narrow), row aggregations, and per-row cell
    math; closes on column/full aggregation or an Xᵀ(chain) product."""

    ttype = TType.ROW

    def open(self, h: Node) -> bool:
        if _narrow_mm(h):
            return True
        if h.is_agg and h.inputs[0].shape[1] > 1:      # agg over a matrix
            return True
        return False

    def fuse(self, h: Node, inp: Node) -> bool:
        if h.is_cellwise:
            return _row_compatible_shapes(h)
        if h.is_agg:
            return True
        if h.is_matmul:
            a, b = h.inputs
            if not _narrow_mm(h):
                return False
            # (chain) @ B  — chain rows stay rows (vectMatMult per row)
            if inp.nid == a.nid and not h.ta:
                return True
            # t(X) @ (chain) — column-transposed aggregation (col_t_agg):
            # accumulates x_rowᵀ ⊗ chain_row into a (k,n) output.
            if inp.nid == b.nid and h.ta and not h.tb:
                return True
            return False
        if h.op == "idx":
            return True
        return False

    def merge(self, h: Node, inp: Node) -> bool:
        if h.is_matmul:
            # a Row op opened at a matmul may merge plans at either operand
            return _narrow_mm(h)
        return self.fuse(h, inp)

    def close(self, h: Node, graph: Graph) -> Status:
        if h.is_agg and h.agg_axis in ("col", "full"):
            return Status.CLOSED_VALID
        if h.is_matmul and h.ta and not h.tb:
            return Status.CLOSED_VALID      # col_t_agg
        return Status.OPEN_VALID


# --------------------------------------------------------------------------
class MAggTpl(Template):
    """Multi-aggregate template: a single full aggregation over a cell chain;
    selection/codegen later combines MAgg roots sharing inputs into one fused
    operator with k outputs (paper Fig. 1(c), §5.2)."""

    ttype = TType.MAGG

    def open(self, h: Node) -> bool:
        if not _is_full_agg(h):
            return False
        src = h.inputs[0]
        return src.is_cellwise or src.is_input

    def fuse(self, h: Node, inp: Node) -> bool:
        return False                        # nothing extends beyond the agg

    def merge(self, h: Node, inp: Node) -> bool:
        return _is_full_agg(h)              # merge the cell chain below

    def close(self, h: Node, graph: Graph) -> Status:
        return Status.CLOSED_VALID          # closed at its own root


# --------------------------------------------------------------------------
class OuterTpl(Template):
    """Sparsity-exploiting outer-product template: binds non-zero (blocks of)
    X, rows of U and V from an outer-like product U @ t(V), plus dense side
    inputs.  Valid only if a sparse driver makes the chain sparse-safe
    (paper: "Outer templates are also validated for the existence of
    sparsity exploiting operators")."""

    ttype = TType.OUTER

    def open(self, h: Node) -> bool:
        return _outer_mm(h)

    def fuse(self, h: Node, inp: Node) -> bool:
        if h.is_cellwise:
            return _row_compatible_shapes(h)
        if _is_full_agg(h):
            return True                     # sum(...) -> full_agg variant
        if h.is_matmul:
            if _outer_mm(h):
                return False                # that would be a nested outer
            a, b = h.inputs
            m, k, n = h.mm_dims()
            # right_mm: (chain) @ V ; left_mm: t(chain) @ U
            if inp.nid == a.nid and not h.ta and n <= OUTER_RANK_MAX:
                return True
            if inp.nid == b.nid and h.ta and n <= OUTER_RANK_MAX:
                return True
            return False
        return False

    def merge(self, h: Node, inp: Node) -> bool:
        return self.fuse(h, inp) or self.open(h)

    def close(self, h: Node, graph: Graph) -> Status:
        if _outer_mm(h):
            # the outer product itself: extendable, but rooting here would
            # materialize the dense m×n product — exactly what we must avoid.
            return Status.OPEN_INVALID
        closing = _is_full_agg(h) or (h.is_matmul and not _outer_mm(h))
        if not closing:
            if h.is_cellwise and _has_sparse_driver(h):
                return Status.OPEN_VALID    # no_agg variant may root here
            return Status.OPEN_INVALID
        return (Status.CLOSED_VALID if _reaches_sparse_driver(h)
                else Status.CLOSED_INVALID)


def _has_sparse_driver(h: Node) -> bool:
    """Structural sparse-safety: ∃ leaf matrix L (not a factor of the outer
    matmul) with sparse-safe path to the cell chain at h."""
    leaves, factors = _collect_outer_leaves(h)
    return any(sparse_safe_wrt(h, lf) for lf in leaves
               if lf.nid not in factors and not lf.is_scalar
               and not lf.is_vector)


def _reaches_sparse_driver(h: Node) -> bool:
    """For closing hops (mm/agg over the chain), validate the chain input."""
    if h.is_agg:
        return _has_sparse_driver(h.inputs[0])
    if h.is_matmul:
        a, b = h.inputs
        chain = b if h.ta else a
        return _has_sparse_driver(chain)
    return _has_sparse_driver(h)


def _collect_outer_leaves(h: Node) -> tuple[list[Node], set[int]]:
    leaves: list[Node] = []
    factors: set[int] = set()
    seen: set[int] = set()
    stack = [h]
    while stack:
        n = stack.pop()
        if n.nid in seen:
            continue
        seen.add(n.nid)
        if n.is_input:
            leaves.append(n)
        elif _outer_mm(n):
            factors.update(i.nid for i in n.inputs)
            stack.extend(n.inputs)
        else:
            stack.extend(n.inputs)
    return leaves, factors


TEMPLATES: dict[TType, Template] = {
    TType.CELL: CellTpl(),
    TType.ROW: RowTpl(),
    TType.MAGG: MAggTpl(),
    TType.OUTER: OuterTpl(),
}


# --------------------------------------------------------------------------
# distributed template variants (hybrid local/distributed plans)
# --------------------------------------------------------------------------
#
# Every template above also has a *distributed* variant: the generated
# operator body runs unchanged on a row shard of its iteration domain
# (``shard_map`` over the mesh's data/FSDP axes), and a per-variant
# collective epilogue restores the global result.  This table is the
# registry of which (template, skeleton-variant) pairs distribute and how:
#
# * ``"none"``   — the output is row-partitioned exactly like the inputs
#                  (Cell/Row no_agg, row_agg, Outer right_mm): each shard
#                  writes its own slice, no communication.
# * ``"reduce"`` — each shard produces a *partial* of the full output that
#                  an all-reduce over the row axes completes (full/col
#                  aggregates, Row col_t_agg, Outer left_mm — everything
#                  whose reduction axis is the sharded one).  The concrete
#                  collective is picked per aggregation op by
#                  :func:`dist_epilogue` (``psum`` / ``pmin`` / ``pmax``);
#                  ``mean`` partials do not compose associatively per
#                  shard, so mean-rooted operators stay local.
#
# Variant names are the CPlan skeleton variants (``core/cplan.py``); kept
# as string literals here because cplan imports this module.
DIST_VARIANTS: dict[tuple[TType, str], str] = {
    (TType.CELL, "no_agg"):    "none",
    (TType.CELL, "row_agg"):   "none",
    (TType.CELL, "col_agg"):   "reduce",
    (TType.CELL, "full_agg"):  "reduce",
    (TType.ROW, "no_agg"):     "none",
    (TType.ROW, "row_agg"):    "none",
    (TType.ROW, "col_agg"):    "reduce",
    (TType.ROW, "full_agg"):   "reduce",
    (TType.ROW, "col_t_agg"):  "reduce",
    (TType.MAGG, "full_agg"):  "reduce",
    # Outer distributes only where the reduction axis is the sharded row
    # axis of the sparse driver: left_mm (t(chain) @ U) and the full/col
    # aggregates.  right_mm's reduction runs over columns, which stay
    # local to each row shard — but its *output* is the dense m×n-shaped
    # product row block, which the template exists to avoid materializing
    # globally; it distributes as a row-partitioned write.
    (TType.OUTER, "right_mm"): "none",
    (TType.OUTER, "left_mm"):  "reduce",
    (TType.OUTER, "full_agg"): "reduce",
    (TType.OUTER, "col_agg"):  "reduce",
}

#: aggregation op → collective completing a "reduce" epilogue.
_REDUCE_COLLECTIVE = {"sum": "psum", "sum_sq": "psum",
                      "min": "pmin", "max": "pmax"}


def dist_epilogue(ttype: TType, variant: str, agg_op: str) -> Optional[str]:
    """Collective epilogue of the distributed variant of (template,
    variant), or None when no distributed variant exists: ``"none"``
    (row-partitioned output), or the all-reduce flavour (``"psum"`` /
    ``"pmin"`` / ``"pmax"``) matching the aggregation op."""
    kind = DIST_VARIANTS.get((ttype, variant))
    if kind is None:
        return None
    if kind == "none":
        return "none"
    return _REDUCE_COLLECTIVE.get(agg_op)
