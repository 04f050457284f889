"""Dispatch layer for generated fused operators (one device).

Given a CPlan and bound operands, pick an execution path — the routing of
the reference's ``repro/kernels/ops.py``, kept exactly:

* **dense, ``kernels="never"``** — interpret the program op by op in torch
  (:func:`repro_torch.kernels.ref.execute_dense`);
* **dense, ``kernels="cuda"``** — a multi-root CPlan (``cplan.extra``) runs
  the MAgg kernel, CELL or single-root MAGG the Cell kernel, ROW the Row
  kernel; an Outer CPlan over a dense main runs the torch oracle, as the
  reference falls through to XLA;
* **BCSR main** — when the planner certified the chain sparse-safe
  (``cplan.main.exploit``) and it is an Outer CPlan or has no matmul, the
  work runs over the non-zero blocks only: Outer ``right_mm`` and
  ``full_agg`` under ``kernels="cuda"`` run the Outer kernel
  (:mod:`repro_torch.kernels.outerprod`); every other sparse route — Outer
  ``no_agg`` / ``left_mm`` and the sparse-safe Cell, Row and MAgg chains —
  runs the torch block loop :func:`_execute_bcsr` under either policy.
  That is the reference's own routing: it has no Pallas kernel for those
  routes and runs its jnp block loop there.  A main the plan cannot
  exploit is densified and takes the dense paths.

* **CLA main** (:class:`~repro_torch.kernels.blocksparse.DictCompressed`)
  — a qualifying single-input ``sum`` chain runs over the per-column
  dictionaries and aggregates through the counts (:func:`_execute_dict`,
  paper Fig. 9); any other plan densifies the main through ``todense()``
  and re-dispatches on the dense paths, as the reference does.

:func:`execute_batched` is the request-axis form of the dense dispatch:
every bound value carries a leading request axis (B, r, c) — a 2-D value
is shared by every request — and one call of the Cell, MAgg or Row kernel
serves the whole batch (the counterpart of one vmapped ``pallas_call``).

Each kernel wrapper takes its plain version for CPU tensors only.  Also
hosts the block-sparse *basic* operators (sparse matmul etc.) that a plan
leaves unfused.  Sums over blocks are deterministic: blocks are grouped by
block row (or column) and summed in order (:func:`_segment_sum`), never
with float atomics.
"""

from __future__ import annotations

import torch

from typing import Optional

from repro_torch import faults
from repro_torch.core.cplan import (CPlan, COL_AGG, FULL_AGG, LEFT_MM,
                                    NO_AGG, RIGHT_MM, ROW_AGG)
from repro_torch.core.templates import TType
from . import cellwise, multiagg, ref, rowwise
from .blocksparse import BCSR, DictCompressed

faults.register_site(
    "kernels.launch",
    "a fused operator's dispatch to a generated CUDA kernel (kernels != "
    "'never'), before the kernel is built or launched",
    kinds=("error", "latency"),
    handler="per-plan: FusionServer degradation ladder re-executes the "
            "request at a lower tier; per-op: the error surfaces to the "
            "caller — nothing is cached, a retry re-dispatches")


# --------------------------------------------------------------------------
# public entry: execute a CPlan on bound values
# --------------------------------------------------------------------------

def execute(cplan: CPlan, env: dict, *, kernels: str = "never"):
    """Run one fused operator.  ``kernels`` ∈ {"never", "cuda"}."""
    for v in env.values():
        if not isinstance(v, (torch.Tensor, BCSR, DictCompressed)):
            raise NotImplementedError(
                f"operand of type {type(v).__name__}: the port takes dense "
                f"tensors, BCSR and DictCompressed")
    if kernels != "never":
        faults.fault_point("kernels.launch")
    main = env.get(cplan.main.nid)
    if isinstance(main, DictCompressed):
        out = _execute_dict(cplan, env)
        if out is not None:
            return out
        env = dict(env)
        env[cplan.main.nid] = main = main.todense()
    if isinstance(main, BCSR):
        has_mm = any(op == "matmul" for (_, op, *_rest) in cplan.prog)
        if cplan.main.exploit and (cplan.ttype == TType.OUTER or not has_mm):
            if kernels != "never" and cplan.ttype == TType.OUTER \
                    and cplan.variant in (RIGHT_MM, FULL_AGG):
                from . import outerprod
                return outerprod.outer(cplan, env)
            return _execute_bcsr(cplan, env)
    env = {k: _as_dense(v) for k, v in env.items()}   # not exploitable
    if kernels != "never":
        if cplan.extra:
            return multiagg.multiagg(cplan, env)
        if cplan.ttype in (TType.CELL, TType.MAGG):
            return cellwise.cell(cplan, env)
        if cplan.ttype == TType.ROW:
            return rowwise.row(cplan, env)
        # Outer over a dense main: the torch oracle, as the reference
        # falls through to XLA
    return ref.execute_dense(cplan, env)


def execute_batched(cplan: CPlan, env: dict, *, kernels: str = "never"):
    """Run one fused operator over a batch of requests: every 3-D value of
    ``env`` is (B, *shape) with the requests on its leading axis, a 2-D
    value is shared by all of them; returns the output stacked (B, ...).
    Dense operands only (the server batches dense requests only).  Under
    ``kernels="cuda"`` a CUDA batch is one launch of the Cell, MAgg or Row
    kernel's request-axis form; an Outer CPlan over a dense main runs the
    oracle per request, as :func:`execute` does."""
    for v in env.values():
        if not isinstance(v, torch.Tensor):
            raise NotImplementedError(
                f"batched operand of type {type(v).__name__}: batched "
                f"execution takes dense tensors only")
    if kernels != "never":
        faults.fault_point("kernels.launch")
        if cplan.extra:
            return multiagg.multiagg_batched(cplan, env)
        if cplan.ttype in (TType.CELL, TType.MAGG):
            return cellwise.cell_batched(cplan, env)
        if cplan.ttype == TType.ROW:
            return rowwise.row_batched(cplan, env)
    return ref.execute_dense_batched(cplan, env)


# --------------------------------------------------------------------------
# CLA (DictCompressed) fast path — paper Fig. 9
# --------------------------------------------------------------------------

def _execute_dict(cplan: CPlan, env: dict) -> Optional[torch.Tensor]:
    """CLA fast path over a :class:`~repro_torch.kernels.blocksparse.
    DictCompressed` main: evaluate the program on the per-column
    dictionary values only, then aggregate through the occurrence counts
    (``Σ f(distinct) · count``).  It qualifies, as in the reference, only
    when exactly one bound input is not a scalar (the compressed main),
    the variant is ``full_agg`` with ``agg_op == "sum"``, the CPlan is not
    a multi-aggregate (``cplan.extra`` empty), and every other bound value
    is (1, 1) — a side read returns None and the program evaluation's
    ``TypeError`` disqualifies it.  Returns the (1, 1) aggregate, or None:
    :func:`execute` then densifies the main and re-dispatches."""
    mats = [b for b in cplan.binds if b.kind != "scalar"]
    if len(mats) != 1 or cplan.variant != FULL_AGG \
            or cplan.agg_op not in ("sum",) or cplan.extra:
        return None
    X: DictCompressed = env[cplan.main.nid]

    def read(nid: int):
        if nid == cplan.main.nid:
            return X.values                 # (ncol, ndist)
        v = env[nid]
        if hasattr(v, "shape") and tuple(v.shape) == (1, 1):
            return v
        return None
    try:
        (val,) = ref.apply_program(cplan, read, [cplan.prog_root])
    except TypeError:
        return None
    return torch.sum(val * X.counts).reshape(1, 1)


# --------------------------------------------------------------------------
# BCSR sparsity-exploiting execution (the torch block loop)
# --------------------------------------------------------------------------

def _segment_sum(vals: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Sum consecutive runs of ``vals`` (n, ...) along dim 0: segment s is
    ``vals[ptr[s]:ptr[s + 1]]``, summed in order; empty segments give 0.
    Deterministic on every device (no atomics)."""
    lengths = (ptr[1:] - ptr[:-1]).to(torch.int64)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                initial=0.0)


def _segments(idx: torch.Tensor, nseg: int):
    """(stable order grouping ``idx``, its segment pointer (nseg + 1,))."""
    order = torch.argsort(idx, stable=True)
    bounds = torch.arange(nseg + 1, dtype=idx.dtype, device=idx.device)
    return order, torch.searchsorted(idx[order].contiguous(), bounds)


def _row_sum(vals: torch.Tensor, X: BCSR) -> torch.Tensor:
    """Per block row of ``X``: the sum of ``vals`` (nb, ...) over its
    blocks, in block order → (mb, ...)."""
    return _segment_sum(vals, X.rowptr)


def _col_sum(vals: torch.Tensor, X: BCSR) -> torch.Tensor:
    """Per block column of ``X``: the sum of ``vals`` (nb, ...) over its
    blocks, in block-row order → (nbc, ...)."""
    order, ptr = _segments(X.cols, X.shape[1] // X.bs)
    return _segment_sum(vals[order], ptr)


def _gather_blocks(x: torch.Tensor, idx: torch.Tensor, bs: int,
                   axis: int) -> torch.Tensor:
    """Gather (nb, bs, k) row-panels (axis=0) or (nb, k, bs) col-panels."""
    idx = idx.long()
    if axis == 0:
        return x.reshape(x.shape[0] // bs, bs, x.shape[1])[idx]
    panels = x.reshape(x.shape[0], x.shape[1] // bs, bs).permute(1, 0, 2)
    return panels[idx]


def _block_env(cplan: CPlan, env: dict, X: BCSR):
    """Per-block views of every bound input: main → (nb,bs,bs) blocks, side
    inputs gathered by block row/col, scalars broadcast."""
    bs = X.bs
    m, n = X.shape

    def read(nid: int):
        if nid == cplan.main.nid:
            return X.data
        v = _as_dense(env[nid])
        r, c = v.shape
        if (r, c) == (1, 1):
            return v.reshape(1, 1, 1)
        if (r, c) == (m, n):        # aligned matrix: gather (bs,bs) blocks
            blocks = v.reshape(m // bs, bs, n // bs, bs).permute(0, 2, 1, 3)
            return blocks[X.rows.long(), X.cols.long()]
        if c == 1 and r == m:       # column vector: (nb, bs, 1)
            return v.reshape(m // bs, bs, 1)[X.rows.long()]
        if r == 1 and c == n:       # row vector: (nb, 1, bs)
            return v.reshape(1, n // bs, bs).permute(1, 0, 2)[X.cols.long()]
        raise NotImplementedError(
            f"side input {tuple(v.shape)} vs sparse main {X.shape}")

    return read


def _execute_bcsr(cplan: CPlan, env: dict):
    X: BCSR = env[cplan.main.nid]
    bs = X.bs
    m, n = X.shape
    read = _block_env(cplan, env, X)

    # every aggregate root of a multi-aggregate (the reference's block loop
    # evaluates only the first and returns it for each: ROADMAP queue C)
    roots = [cplan.prog_root] + [r for r, _op in cplan.extra]
    in_prog = {nid for (nid, *_r) in cplan.prog}
    if cplan.close_nid is not None and cplan.close_nid in in_prog:
        roots.append(cplan.close_nid)

    ub = vb = None
    if cplan.ttype == TType.OUTER:
        fu = _as_dense(env[_kind_nid(cplan, "factor_u")])
        fv = _as_dense(env[_kind_nid(cplan, "factor_v")])
        ub = _gather_blocks(fu, X.rows, bs, 0)       # (nb, bs, r)
        vb = _gather_blocks(fv, X.cols, bs, 0)       # (nb, bs, r)
    vals = _apply_prog_blocked(cplan, read, roots, ub, vb)
    del ub, vb

    val = vals[0]                                     # (nb, bs, bs)
    v = cplan.variant
    if v == FULL_AGG:
        if cplan.extra:
            outs = [_block_agg(vals[0], cplan.agg_op)]
            for x_val, op in zip(vals[1:], [op for _, op in cplan.extra]):
                outs.append(_block_agg(x_val, op))
            return torch.cat(outs, dim=0)
        return _block_agg(val, cplan.agg_op)
    if v == RIGHT_MM:
        closer = _as_dense(env[cplan.close_nid])
        cb = _gather_blocks(closer.T if cplan.close_tb else closer,
                            X.cols, bs, 0)            # (nb, bs, k)
        contrib = torch.bmm(val, cb)
        del val, vals, cb
        return _row_sum(contrib, X).reshape(m, -1)
    if v == LEFT_MM:
        closer = _as_dense(env[cplan.close_nid])
        cb = _gather_blocks(closer, X.rows, bs, 0)    # (nb, bs, k)
        contrib = torch.bmm(val.transpose(1, 2), cb)
        del val, vals, cb
        return _col_sum(contrib, X).reshape(n, -1)
    if v == NO_AGG:
        return BCSR(val.contiguous(), X.rows, X.cols, X.shape, bs,
                    X._rowptr)
    if v == ROW_AGG:
        assert cplan.agg_op == "sum", "sparse row_agg supports sum"
        return _row_sum(val.sum(dim=2), X).reshape(m, 1)
    if v == COL_AGG:
        assert cplan.agg_op == "sum", "sparse col_agg supports sum"
        return _col_sum(val.sum(dim=1), X).reshape(1, n)
    raise NotImplementedError(f"BCSR variant {v}")


def _last_reads(cplan: CPlan) -> dict[int, int]:
    """Program position of the last read of every program value."""
    last: dict[int, int] = {}
    for pos, (_nid, _op, ins, _shape, _attrs) in enumerate(cplan.prog):
        for kind, r in ins:
            if kind == "n":
                last[r] = pos
    return last


def _apply_prog_blocked(cplan: CPlan, read, roots, ub, vb):
    """Interpret the program with (nb, bs, bs) block values; an interior
    outer matmul evaluates as per-block U_bi @ V_bjᵀ.  A value is dropped
    after its last read (the block values are as large as X)."""
    vals: dict[int, torch.Tensor] = {}
    last = _last_reads(cplan)
    keep = set(roots)
    for pos, (nid, op, ins, _shape, attrs) in enumerate(cplan.prog):
        if op == "matmul" and ub is not None:
            # the outer product: U @ t(V) evaluated per non-zero block
            vals[nid] = torch.bmm(ub, vb.transpose(1, 2))
        else:
            argv = []
            for kind, r in ins:
                if kind == "n":
                    argv.append(vals[r])
                elif kind == "b":
                    argv.append(read(r))
                else:
                    argv.append(r)
            vals[nid] = ref.eval_node(op, argv, dict(attrs))
        for kind, r in ins:
            if kind == "n" and last.get(r) == pos and r not in keep:
                vals.pop(r, None)
    return [vals[r] if r in vals else read(r) for r in roots]


def _block_agg(val: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return torch.sum(val).reshape(1, 1)
    if op == "min":
        return torch.amin(val).reshape(1, 1)   # pseudo-sparse-safe: min ≤ 0
    if op == "max":
        return torch.amax(val).reshape(1, 1)
    raise NotImplementedError(op)


def _kind_nid(cplan: CPlan, kind: str) -> int:
    for b in cplan.binds:
        if b.kind == kind:
            return b.nid
    raise KeyError(kind)


def _as_dense(v):
    return v.todense() if isinstance(v, (BCSR, DictCompressed)) else v


# --------------------------------------------------------------------------
# block-sparse basic operators (for unfused plans over sparse data)
# --------------------------------------------------------------------------

def bcsr_matmul(a: BCSR, b: torch.Tensor) -> torch.Tensor:
    """(m,n) BCSR @ (n,k) dense → (m,k) dense."""
    bb = _gather_blocks(b, a.cols, a.bs, 0)           # (nb, bs, k)
    contrib = torch.bmm(a.data, bb)
    del bb
    return _row_sum(contrib, a).reshape(a.shape[0], -1)


def bcsr_cellwise(op: str, a: BCSR) -> BCSR:
    """Sparse-safe unary over non-zero blocks."""
    return BCSR(ref.eval_node(op, [a.data], {}), a.rows, a.cols, a.shape,
                a.bs, a._rowptr)


def bcsr_mul_dense(a: BCSR, d: torch.Tensor) -> BCSR:
    m, n = a.shape
    blocks = d.reshape(m // a.bs, a.bs, n // a.bs, a.bs).permute(0, 2, 1, 3)
    return BCSR(a.data * blocks[a.rows.long(), a.cols.long()], a.rows,
                a.cols, a.shape, a.bs, a._rowptr)
