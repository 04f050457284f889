"""The kernel sweep: small expressions whose CPlans, built by the planner
itself, drive every variant of the Cell, MAgg and Row kernels, and the
Outer kernel's ``right_mm`` and ``full_agg`` over block-sparse mains.

``chip_smoke.py`` holds each generated CUDA kernel against its plain
version on these CPlans; the CPU tests hold the plain versions against the
reference's Pallas kernels on the same expressions.  Expressions take the
IR module as their first argument, so the tests can build the same
expression with the reference's IR and plan it there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core import cost, cplan, explore, ir, select, templates
from repro_torch.kernels.blocksparse import PIECE_BLOCKS


def _operands(m: int, n: int) -> dict[str, tuple[int, int]]:
    return {"X": (m, n), "Y": (m, n), "v": (m, 1), "B1": (n, 1),
            "B4": (n, 4), "B256": (n, 256), "Y4": (m, 4), "B5": (n, 5),
            "Y5": (m, 5), "c5": (1, 5), "r": (1, n)}


@dataclass(frozen=True)
class Case:
    name: str
    template: str                 # kernel that runs it: cell | magg | row
    expr: Callable                # expr(ir, **operands) -> Expr | tuple
    operands: tuple[str, ...]     # names from _operands
    #: template forced at the output root ("CELL" / "ROW" / "MAGG"), or
    #: None for the planner's own choice (the last fused operator)
    want: Optional[str]
    #: fewest main columns the case plans at (a narrow matmul needs two)
    min_n: int = 1

    def shapes(self, m: int, n: int) -> dict[str, tuple[int, int]]:
        all_ = _operands(m, n)
        return {k: all_[k] for k in self.operands}


def _cell_chain(ir, X, Y, v):
    return ir.abs_(X) * Y + v * 2.0


def _cell(axis: Optional[str], agg: Optional[str]):
    if axis is None:
        return lambda ir, X, Y, v: _cell_chain(ir, X, Y, v)
    return lambda ir, X, Y, v: _cell_chain(ir, X, Y, v)._agg(agg, axis)


def _softmax(ir, X, B4):
    Z = X @ B4
    E = ir.exp(Z - Z.rowmaxs())
    return E / E.rowsums()


def _hvp(ir, X, B5, Y5):
    """The paper's Expression (2), MLogReg's Hessian-vector product."""
    Q = Y5 * (X @ B5)
    return X.T @ (Q - Y5 * Q.rowsums())


def cases() -> list[Case]:
    """Every Cell variant × sum/min/max/mean, single-root MAgg, k = 2 and
    k = 3 MAgg with mixed aggregates, every Row variant with narrow
    matmuls of 1, 4 and 256 columns and in-program rowsums/rowmaxs,
    column slices (``idx``) of sides and of computed row values, a Cell
    sum of non-negative terms (a lost partial cannot cancel out), and Cell
    chains over a (1,n) side, as the autoencoder's bias terms are (the
    Cell kernel's vector walk where n % 4 == 0)."""
    xyv = ("X", "Y", "v")
    out = [Case("cell/no_agg", "cell", _cell(None, None), xyv, None)]
    for axis in ("row", "col", "full"):
        for agg in ("sum", "min", "max", "mean"):
            out.append(Case(f"cell/{axis}_agg_{agg}", "cell",
                            _cell(axis, agg), xyv, "CELL"))
    out += [
        Case("cell/full_agg_abs_sum", "cell",
             lambda ir, X, Y, v: ir.abs_(_cell_chain(ir, X, Y, v)).sum(),
             xyv, "CELL"),
        Case("cell/no_agg_row_side", "cell",
             lambda ir, X, Y, r: ir.sigmoid(X + r) * Y, ("X", "Y", "r"),
             None),
        Case("cell/full_agg_row_side", "cell",
             lambda ir, X, Y, r: ((X + r - Y) ** 2).sum(), ("X", "Y", "r"),
             "CELL"),
        Case("cell/magg_single", "cell",
             lambda ir, X, Y: (X * Y).sum(), ("X", "Y"), "MAGG"),
        Case("magg/k2_sum_max", "magg",
             lambda ir, X, Y: ((X * Y).sum(), (X ** 2).max_()),
             ("X", "Y"), None),
        Case("magg/k3_min_mean_sum", "magg",
             lambda ir, X, Y: ((X * Y).min_(), (X ** 2).mean(),
                               ir.abs_(Y).sum()),
             ("X", "Y"), None),
        Case("row/no_agg_mm1", "row",
             lambda ir, X, B1, v: ir.relu(1.0 - v * (X @ B1)),
             ("X", "B1", "v"), "ROW"),
        Case("row/no_agg_mm4", "row",
             lambda ir, X, B4, v: ir.exp(X @ B4) * v,
             ("X", "B4", "v"), "ROW"),
        Case("row/no_agg_mm256", "row",
             lambda ir, X, B256: ir.tanh(X @ B256) * 0.5,
             ("X", "B256"), "ROW"),
        Case("row/no_agg_rowsums_rowmaxs", "row", _softmax,
             ("X", "B4"), None),
        Case("row/row_agg_sum", "row",
             lambda ir, X, B4: ((X @ B4) * 2.0).rowsums(),
             ("X", "B4"), None),
        Case("row/row_agg_max", "row",
             lambda ir, X, B4: ir.sigmoid(X @ B4)._agg("max", "row"),
             ("X", "B4"), None),
        Case("row/col_agg_sum", "row",
             lambda ir, X, v: (ir.abs_(X) * v).colsums(),
             ("X", "v"), "ROW"),
        Case("row/col_agg_mean", "row",
             lambda ir, X, v: (X * v - 1.0)._agg("mean", "col"),
             ("X", "v"), "ROW"),
        Case("row/full_agg", "row",
             lambda ir, X, B4: ((X @ B4) ** 2).sum(),
             ("X", "B4"), "ROW"),
        Case("row/col_t_agg_mm4", "row",
             lambda ir, X, B4, Y4: X.T @ (Y4 * (X @ B4)),
             ("X", "B4", "Y4"), "ROW"),
        Case("row/col_t_agg_mm1", "row",
             lambda ir, X, B1: X.T @ ir.relu(X @ B1),
             ("X", "B1"), "ROW"),
        Case("row/full_agg_max", "row",
             lambda ir, X, B4: ir.tanh(X @ B4)._agg("max", "full"),
             ("X", "B4"), "ROW"),
        Case("row/col_agg_min_mm4", "row",
             lambda ir, X, B4: (X @ B4)._agg("min", "col"),
             ("X", "B4"), "ROW"),
        Case("row/idx_computed_row_mean", "row",
             lambda ir, X, B4: ir.exp(X @ B4).cols(1, 3)._agg("mean", "row"),
             ("X", "B4"), None),
        Case("row/idx_side", "row",
             lambda ir, X, B4: X.cols(0, 4) * (X @ B4),
             ("X", "B4"), None, min_n=4),
        Case("row/no_agg_softmax_mm5", "row",
             lambda ir, X, B5: _softmax(ir, X, B5), ("X", "B5"), None),
        Case("row/col_t_agg_hvp_mm5", "row", _hvp, ("X", "B5", "Y5"),
             "ROW"),
        Case("row/no_agg_wide_tb", "row",
             lambda ir, X, B5, Y5: (ir.sigmoid(X @ B5) - Y5) @ B5.T,
             ("X", "B5", "Y5"), None),
        Case("row/row_agg_min_w5", "row",
             lambda ir, Y5, v, c5: (v - 2.0 * Y5 + c5)._agg("min", "row"),
             ("Y5", "v", "c5"), None),
        Case("cell/idx_where", "cell",
             lambda ir, X, Y: ir.where(X.cols(1, X.shape[1]) > 0.0,
                                       Y.cols(0, Y.shape[1] - 1), 1.0),
             ("X", "Y"), None, min_n=2),
    ]
    return [replace(c, min_n=max(c.min_n, 2)) if c.template == "row" else c
            for c in out]


def fused_cplan(case, m: int, n: int, sparsity: Optional[dict] = None):
    """Plan ``case`` at (m, n) with the port's planner (``sparsity``: per
    operand, default 1.0); returns (cplan, {bind nid: operand name})."""
    sparsity = sparsity or {}
    exprs = {k: ir.matrix(k, s, sparsity=sparsity.get(k, 1.0))
             for k, s in case.shapes(m, n).items()}
    outs = case.expr(ir, **exprs)
    g = ir.Graph.build(list(outs) if isinstance(outs, tuple) else [outs])
    if case.want is not None:
        memo = explore.explore(g)
        root = g.outputs[0]
        want = templates.TType[case.want]
        entry = next(e for e in memo.entries(root.nid)
                     if e.ttype == want and e.can_root)
        spec = cost._build_spec(g, memo, root.nid, entry, set())
    else:
        p = select.plan(g, "gen")
        spec = [s for s in p.specs if getattr(s, "fused", False)][-1]
    cp = cplan.build_cplan(g, spec)
    names = {node.nid: node.name for node in g.inputs()}
    return cp, {b.nid: names[b.nid] for b in cp.binds}


def with_rows(cp, m: int):
    """``cp`` over ``m`` rows: every shape whose row count is the main's
    (more than one row) takes ``m``.  The generated sources do not depend
    on the row count, so this reaches row counts the planner does not fuse
    at, down to a single cell."""
    rows = cp.main.shape[0]
    if rows < 2:
        raise ValueError(f"CPlan over {rows} row(s): nothing to resize")
    fit = lambda shape: (m, shape[1]) if shape[0] == rows else tuple(shape)
    return replace(
        cp, binds=[replace(b, shape=fit(b.shape)) for b in cp.binds],
        prog=[(nid, op, ins, fit(shape), attrs)
              for (nid, op, ins, shape, attrs) in cp.prog],
        out_shape=fit(cp.out_shape))


# --------------------------------------------------------------------------
# Outer: block SDDMM over a BCSR main
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class OuterCase:
    """One Outer CPlan over a BCSR main X of ``grid`` (block rows, block
    cols) blocks of ``bs``: ``((X≠0) ⊙ (U Vᵀ)) [⊙ S] @ V`` (``right_mm``;
    ``@ t(w)``, w (1, n), with ``closer``) or its sum
    (``full_agg``); ``loss`` is ALS's Σ((X≠0)⊙(UVᵀ) − X)²."""
    name: str
    variant: str                  # "right_mm" | "full_agg"
    bs: int
    grid: tuple[int, int]
    density: float                # block density; 0.0: one forced block
    r: int
    #: side S: "col" (m,1), "row" (1,n), "scalar" (1,1), "full" (m,n)
    side: Optional[str] = None
    empty_rows: tuple[int, ...] = ()
    loss: bool = False
    #: blocks in each block row (at seeded columns), in place of density
    row_blocks: tuple[int, ...] = ()
    #: close with t(w), w (1, n), in place of V
    closer: bool = False
    template: str = "outer"
    want: str = "OUTER"

    @property
    def shape(self) -> tuple[int, int]:
        return self.grid[0] * self.bs, self.grid[1] * self.bs

    def shapes(self, m: int, n: int) -> dict[str, tuple[int, int]]:
        out = {"X": (m, n), "U": (m, self.r), "V": (n, self.r)}
        if self.side is not None:
            out["S"] = {"col": (m, 1), "row": (1, n), "scalar": (1, 1),
                        "full": (m, n)}[self.side]
        if self.closer:
            out["W"] = (1, n)
        return out

    def expr(self, ir, X, U, V, S=None, W=None):
        c = ir.neq0(X) * (U @ V.T)
        if self.loss:
            return ((c - X) ** 2).sum()
        if S is not None:
            c = c * S
        if self.variant == "full_agg":
            return c.sum()
        return c @ (V if W is None else W.T)


def outer_cases() -> list[OuterCase]:
    """``right_mm`` and ``full_agg`` at bs 16 and 128, rank 8 and 20, block
    densities 0.0 (one forced block), 0.3 and 1.0; a grid with empty block
    rows; one case each with an (m,1), (1,n), (1,1) and (m,n) side; the
    ALS loss chain (a sum of non-negative terms); a closer other than V
    (t(w) of a (1, n) side: one output column);
    block rows longer than a piece of the kernel's grid (C =
    ``PIECE_BLOCKS``): rows of 1, 0, C, C + 1, 2C + 16, 2C, 5 and 0 blocks
    at bs 16 (the template needs m ≥ 128), and of C + 1, 0 and 2C + 2 at
    bs 128, rank 20."""
    out = []
    for variant in ("right_mm", "full_agg"):
        for bs, grid in ((128, (4, 3)), (16, (8, 9))):
            for r in (8, 20):
                for d in (0.0, 0.3, 1.0):
                    out.append(OuterCase(f"outer/{variant}_bs{bs}_r{r}_d{d}",
                                         variant, bs, grid, d, r))
        out.append(OuterCase(f"outer/{variant}_empty_rows", variant, 128,
                             (5, 3), 0.7, 20, empty_rows=(1, 3)))
    out += [
        OuterCase("outer/right_mm_side_col", "right_mm", 128, (4, 3), 0.5,
                  20, side="col"),
        OuterCase("outer/full_agg_side_row", "full_agg", 128, (4, 3), 0.5,
                  20, side="row"),
        OuterCase("outer/right_mm_side_scalar", "right_mm", 16, (8, 9), 0.5,
                  8, side="scalar"),
        OuterCase("outer/full_agg_side_full", "full_agg", 128, (4, 3), 0.5,
                  20, side="full"),
        OuterCase("outer/full_agg_loss", "full_agg", 128, (4, 3), 0.7, 20,
                  loss=True),
        OuterCase("outer/right_mm_closer_w", "right_mm", 128, (4, 3), 0.5,
                  20, closer=True),
    ]
    C = PIECE_BLOCKS
    for variant in ("right_mm", "full_agg"):
        out.append(OuterCase(f"outer/{variant}_long_rows_bs16", variant, 16,
                             (8, 2 * C + 16), 0.0, 8,
                             row_blocks=(1, 0, C, C + 1, 2 * C + 16, 2 * C,
                                         5, 0)))
    out.append(OuterCase("outer/right_mm_long_rows_bs128", "right_mm", 128,
                         (3, 2 * C + 2), 0.0, 20,
                         row_blocks=(C + 1, 0, 2 * C + 2)))
    return out


def outer_values(case: OuterCase, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded numpy operands of ``case`` (an :class:`OuterCase`, or any
    object with its grid, density and shapes): X dense (m, n), zero
    outside its non-zero blocks, plus U, V and the side."""
    rng = np.random.default_rng(seed)
    mb, nbc = case.grid
    mask = rng.random((mb, nbc)) < case.density
    row_blocks = getattr(case, "row_blocks", ())
    for r, nblk in enumerate(row_blocks):
        mask[r] = False
        mask[r, rng.permutation(nbc)[:nblk]] = True
    mask[list(case.empty_rows), :] = False
    if not row_blocks:
        mask.flat[0] = True
    m, n = case.shape
    vals = {"X": (rng.normal(size=(m, n))
                  * np.kron(mask, np.ones((case.bs, case.bs)))
                  ).astype(np.float32)}
    for k, s in case.shapes(m, n).items():
        if k != "X":
            vals[k] = (rng.normal(size=s) * 0.5).astype(np.float32)
    return vals
