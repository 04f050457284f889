#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py   # L2SVM, MLogReg, GLM and KMeans on X
                            # 10,000,000 x 100, the autoencoder on
                            # 1,000,000 x 784 images, ALS-CG on a BCSR of
                            # 480,256 x 17,792 (the Netflix shape)
    python3 chip_smoke.py --times   # only the main paths' profiles and
                                    # per-CPlan times, no checks: copied
                                    # into another checkout, it measures
                                    # that tree's package the same way

Phases, each reported on its own lines with its wall time:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 switched off for matmuls and cuDNN;
2. build: every kernel this run launches is generated from its CPlan and
   compiled with nvcc, all builds started together;
3. kernels vs plain: every variant of the Cell, MAgg and Row kernels
   (CPlans from the port's planner, ``repro_torch.kernels.sweep``) at a
   ragged shape, at an (m,1) main and at the main path's width, each held
   against its plain PyTorch version on the same CUDA tensors, and the
   Cell kernel over (m,1) domains at m of 1, 3, 5, 7, 33, 1,023 and
   2,000,003 (and (m,4) ones with a (1,4) side), so that every part of its
   vector walk runs; then a fault planted in the kernels' ordered fold
   (the middle partial is dropped, in the Cell kernel's own fold or in
   ``rk::combine``; in a Row ``row_agg``, the middle element of every row,
   or in the warp layout the middle lane's partial; in a tile-layout Row
   ``col_t_agg`` also the middle row slice of each CTA) and one in the
   Cell vector walk (the second cell of every group dropped) must fail the
   same check at 2,000,003 rows; every reducing Cell case gives the same
   bits twice, and a Cell operand off a 16-byte boundary raises; each Row
   line names its layout (tile or warp), each Cell line its walk (vec or
   scal);
4. the main path's own CPlans at the main path's shapes, against plain
   (a reducing Cell CPlan also run twice for the same bits);
5. the main path: ``repro_torch.algos.l2svm.run`` for 5 iterations on
   X (m,100) fp32 with ``kernels="cuda"``, launch counters set to 0 just
   before it and read just after; the same run with ``kernels="never"``
   and the hand-written torch baseline must give the same objective trace,
   and a run with the planted fault must not; one more run under
   ``torch.profiler`` splits the device time by kernel;
6. timing: per main-path CPlan, the kernel's and its plain version's
   median time with CUDA events, beside the bound (bytes over 3.35 TB/s or
   fp32 flops over 67 TFLOP/s, the larger), with the kernels one call
   launched in the profiler (a Cell call must be one Cell kernel) and, for
   a Cell CPlan of 10⁶ cells or more, its SASS instructions per cell and
   the issue floor they give (``[sass]``);
7. ALS-CG: the Outer kernel's sweep (``right_mm`` / ``full_agg`` over BCSR
   mains, ``repro_torch.kernels.sweep.outer_cases``) against its plain
   version, with planted faults that must fail (``right_mm`` skips the
   middle block of every block row; ``full_agg`` drops a partial; the
   ``right_mm`` fold drops the middle piece of every row cut into pieces,
   on the long-row cases); a BCSR
   shaped like the paper's Netflix matrix (480,189 x 17,770 padded to
   480,256 x 17,792, bs 128, block density 0.25, planted rank 8, noise
   0.1) built on the card from a seeded ``torch.Generator``; the ALS
   CPlans at that shape against plain (the V update's also with the fold
   fault planted, which must fail); ``repro_torch.algos.als_cg.run``
   (rank 20, 6 outer x 5 inner iterations) with ``kernels="cuda"``,
   counters set to 0 just before it, its loss trace against
   ``kernels="never"`` and against a planted-fault run; the dense-mask
   hand baseline at a reduced 12,800 x 8,192; a profile; per-CPlan times
   (U update, V update, loss) beside their bounds;
8.-11. MLogReg (k = 5, 3 x 3 Newton-CG iterations), GLM (binomial
   probit, 3 x 3 IRLS-CG iterations), KMeans (k = 5, 5 iterations) on X
   (m,100) fp32, and the autoencoder (784-500-2-500-784, batch 512, 20
   SGD steps) on (1,000,000, 784) images, each with its data drawn on the
   card from a seeded ``torch.Generator``: ``run(kernels="cuda")`` with
   the counters set to 0 just before it and read just after (every kernel
   its CPlans route to must have launched), its trace against
   ``kernels="never"`` (1e-5) and against a planted-fault run (must fail),
   the hand baseline (the reference's 2e-2), KMeans' assignment rows
   summing to 1, a profile, then its CPlans at its shapes against plain
   (reducing Cell CPlans twice, bit for bit; GLM's Cell CPlans also with
   the planted group fault, which must fail) and timed beside their
   bounds;
12. one JSON line with every kernel (launches and times summed over every
   path), the card line, and the final ``{"ok": true, ...}`` line.

Any failed check raises; the script then prints the traceback and exits 1
without a result line.  It imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 100                 # the repo's L2SVM width (docs/architecture.md)
M_MAIN = 10_000_000          # rows: X is 4.0 GB fp32
M_SWEEP = 2_000_003          # sweep rows at the main path's width (ragged)
ITERS = 5
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s (datasheet)
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores, FLOP/s
EPS32 = 2.0 ** -23            # fp32 machine epsilon
#: kernel vs plain, per output element: |got - plain| <= KERNEL_ULPS *
#: EPS32 * scale, where scale is a first-order bound of the plain
#: computation's rounding (error_scale).  Both sides are fp32 and sum in
#: different orders; a sum of non-negative terms that lost one of its P
#: partials is off by about its value / P (P is in the thousands at the
#: sweep's 2,000,003 rows), far above the limit
KERNEL_ULPS = 16
#: objective and loss traces (kernels / torch-eager / hand torch):
#: relative; L2SVM's line search and ALS-CG's CG steps carry
#: reduction-order differences over the iterations
TRACE_RTOL = 1e-5
#: sweep cases at M_SWEEP rows whose planted fault (one partial dropped,
#: in the Cell kernel's own fold or in rk::combine; for a Row row_agg, the middle element of every row in the tile layout,
#: the middle lane's partial in the warp layout; for a tile-layout
#: col_t_agg also the middle row slice's partial of each CTA) must fail the
#: kernel check: sums of non-negative terms (Cell: one in each walk; one
#: per other kernel), a row sum of
#: four terms, and the tile layout's row minimum over (m,5) and MLogReg's
#: Hessian-vector close
PLANTED = ("cell/full_agg_abs_sum", "cell/full_agg_row_side",
           "magg/k3_min_mean_sum", "row/full_agg",
           "row/row_agg_sum", "row/row_agg_min_w5", "row/col_t_agg_hvp_mm5",
           "outer/right_mm_bs128_r20_d1.0", "outer/full_agg_loss")
PLANT = "#define RK_PLANTED_FAULT 1\n"
#: Outer cases whose planted fold fault (the middle piece of every row of
#: two or more pieces dropped) must fail the kernel check; the main path's
#: V update must fail it too
PLANTED_FOLD = ("outer/right_mm_long_rows_bs16",
                "outer/right_mm_long_rows_bs128")
PLANT_FOLD = "#define RK_PLANTED_FOLD 1\n"
#: Cell cases in the vector walk at M_SWEEP rows whose planted group fault
#: (the second cell of every four-cell group dropped: no_agg stores 0, a
#: reduction leaves it out) must fail the kernel check; the GLM path's
#: Cell CPlans must fail it too
PLANTED_GROUP = ("cell/no_agg_row_side", "cell/full_agg_row_side")
PLANT_GROUP = "#define RK_PLANTED_GROUP 1\n"
#: row counts the Cell kernel is held to plain at over an (m,1) domain,
#: so that its vector walk's last round and its cells past the last group
#: are reached (m·N of 1, 3, 5, 7, 33, 1,023 and M_SWEEP), and the (1,4)
#: side cases' row counts (m·N four times these)
TAIL_ROWS = (1, 3, 5, 7, 33, 1023, M_SWEEP)

#: ALS-CG main path: the Netflix ratings shape (480,189 users x 17,770
#: movies) padded to the block size, block density 0.25 (data.ratings'
#: default), planted rank 8, noise 0.1; rank 20, 6 outer x 5 inner
ALS_SHAPE = (480_189, 17_770)
ALS_BS = 128
ALS_DENSITY = 0.25
ALS_RANK = 20
ALS_ITERS = 6
ALS_INNER = 5
#: the dense-mask hand baseline densifies X (34 GB at the full shape): it
#: runs at this reduced shape, beside the gen path on the same matrix
ALS_HAND_SHAPE = (12_800, 8_192)
#: hand vs gen ALS trace: the reference's own tolerance between its hand
#: baseline and the fused path (tests/test_algos.py, 5e-2)
ALS_HAND_RTOL = 5e-2

#: the paper's other dense algorithms, at the L2SVM width (N_MAIN columns;
#: M_MAIN rows for MLogReg, GLM and KMeans); depth cut from the reference's
#: defaults, each cut logged with its phase.  The CG solves stop at 3
#: steps: on this white X the Hessian is near a multiple of the identity,
#: ||r||² falls ~10⁵-fold a step and reaches the fp32 floor of r's updates
#: by the third, while the reference's break rule (||r||² < 1e-12,
#: absolute) never fires at 10⁷ rows; the steps after it work on rounding
#: noise, p·Hp turns negative and the iterate becomes NaN, with the
#: kernels and with torch-eager alike (ROADMAP queue C)
LAM = 1e-3
MLR_K, MLR_OUTER, MLR_INNER = 5, 3, 3        # reference: 10 outer x 20 inner
GLM_OUTER, GLM_INNER = 3, 3                  # reference: 8 outer x 10 inner
KM_K, KM_ITERS = 5, 5                        # reference: 20 iterations
#: the autoencoder: MNIST-shaped images at density 0.25 (data.images), the
#: paper configuration H1 500, H2 2, batch 512; 20 SGD steps, not an epoch
AE_ROWS, AE_N = 1_000_000, 784
AE_H1, AE_H2, AE_BATCH, AE_STEPS = 500, 2, 512, 20
#: hand baseline vs the planned path on the four: the reference's own
#: tolerance between its hand-written baseline and its fused arms
#: (tests/test_algos.py, 2e-2)
HAND_RTOL = 2e-2

KERNELS = {   # name -> (skeleton source, the TPU kernel it replaces)
    "cell": ("src/repro_torch/kernels/csrc/cell.cuh",
             "src/repro/kernels/cellwise.py:55"),
    "magg": ("src/repro_torch/kernels/csrc/magg.cuh",
             "src/repro/kernels/multiagg.py:20"),
    "row": ("src/repro_torch/kernels/csrc/row.cuh",
            "src/repro/kernels/rowwise.py:25"),
    "outer": ("src/repro_torch/kernels/csrc/outer.cuh",
              "src/repro/kernels/outerprod.py:31"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def region_cplans(entries, prefix: str = ""):
    """CPlans of fused regions planned on shapes alone (meta tensors), in
    order: [(label, cplan)], each region's planned backward after its
    forward where ``entries`` (region, args, backward?) asks for it."""
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    out = []
    with FusionContext():
        for region, args, bwd in entries:
            planned = region.trace(*args).plan()
            label = prefix + region.fn.__name__
            out += [(label, cp)
                    for cp in compile_plan(planned.eplan).cplans()]
            if bwd:
                out += [(label + ":vjp", cp) for cp in
                        compile_plan(planned.backward().eplan).cplans()]
    return out


def meta(*shape):
    import torch
    return torch.empty(shape, device="meta")


def main_path_cplans(m: int, n: int):
    """CPlans of one L2SVM iteration, in order: hinge, search terms, the
    objective forward and its planned backward."""
    from repro_torch.algos import l2svm
    X, w, col, lam = meta(m, n), meta(n, 1), meta(m, 1), meta(1, 1)
    return region_cplans([(l2svm._hinge, (X, w, col), False),
                          (l2svm._search_terms, (col, col), False),
                          (l2svm._objective_full, (X, w, col, lam), True)])


def kernel_name(cplan) -> str:
    from repro_torch.kernels import cuda_src
    return cuda_src.source_for(cplan).template


def layout_name(cplan) -> str:
    """The Row kernel's layout ("tile" or "warp"), the Cell kernel's walk
    ("vec" or "scal"), "-" for the others (and for a tree that predates
    them)."""
    from repro_torch.kernels import cuda_src
    src = cuda_src.source_for(cplan)
    walk = getattr(src, "walk", "")
    return {"vector": "vec", "scalar": "scal"}.get(walk) or \
        getattr(src, "layout", "") or "-"


def random_env(cplan, gen, shared=None):
    """Random fp32 operands on the card for every bind (scaled so exp and
    friends stay finite); ``shared`` maps a shape to a tensor to reuse."""
    import torch
    env = {}
    for b in cplan.binds:
        shape = tuple(b.shape)
        if shared is not None and shape in shared:
            env[b.nid] = shared[shape]
        else:
            env[b.nid] = 0.3 * torch.randn(shape, generator=gen,
                                           device="cuda")
    return env


#: piecewise-constant ops: their outputs count as exact under rounding
STEP_OPS = {"sign", "round", "floor", "ceil", "neq0", "eq", "neq", "lt", "le",
            "gt", "ge"}


def _is_t(x) -> bool:
    import torch
    return isinstance(x, torch.Tensor)


def _mag(x):
    return x.abs() if _is_t(x) else abs(x)


def _reduce_scale(op, v, s, axis):
    """The bound of an aggregate of v (carrying s) along ``axis``."""
    import torch
    from repro_torch.kernels import ref
    s = s if _is_t(s) else torch.zeros_like(v)
    if op in ("min", "max"):
        return (ref.eval_node(op, [v], {"axis": axis}).abs()
                + ref.eval_node("max", [s], {"axis": axis}))
    if op == "sum_sq":
        return ref.eval_node("sum", [v * v + 2 * v.abs() * s],
                             {"axis": axis})
    return ref.eval_node(op, [v.abs() + s], {"axis": axis})


def _matmul_scale(a, sa, b, sb):
    out = a.abs() @ b.abs()
    if _is_t(sa):
        out = out + sa @ b.abs()
    if _is_t(sb):
        out = out + a.abs() @ sb
    return out


def _smooth_scale(op, xs, ss, val, attrs):
    import torch
    from repro_torch.kernels import ref
    leaves = [x.detach().expand(val.shape).clone().requires_grad_(True)
              if _is_t(x) and _is_t(s) else x for x, s in zip(xs, ss)]
    want = [x for x in leaves if _is_t(x) and x.requires_grad]
    out = val.abs()
    if want:
        with torch.enable_grad():
            grads = torch.autograd.grad(
                ref.eval_node(op, leaves, attrs).sum(), want)
        carried = iter(s for x, s in zip(leaves, ss)
                       if _is_t(x) and x.requires_grad)
        for g in grads:
            out = out + torch.nan_to_num(g.abs() * next(carried))
    return out


def _op_scale(op, xs, ss, val, attrs):
    """s(v) of one program op from its inputs xs and their bounds ss."""
    from repro_torch.kernels import ref
    if op in ref._AGG_FN and "axis" in attrs:
        return _reduce_scale(op, xs[0], ss[0], attrs["axis"])
    if op == "matmul":
        a, b = xs
        sa, sb = ss
        if attrs.get("ta"):
            a, sa = a.T, (sa.T if _is_t(sa) else sa)
        if attrs.get("tb"):
            b, sb = b.T, (sb.T if _is_t(sb) else sb)
        return _matmul_scale(a, sa, b, sb)
    if op == "t":
        return ss[0].T if _is_t(ss[0]) else ss[0]
    if op == "idx":
        return ss[0][:, attrs["lo"]:attrs["hi"]] if _is_t(ss[0]) else ss[0]
    if op in STEP_OPS:
        return val.abs()
    if op in ("relu", "abs", "neg"):
        return val.abs() + ss[0]
    if op in ("add", "sub", "min", "max"):
        return val.abs() + ss[0] + ss[1]
    if op == "mul":
        return val.abs() + _mag(xs[1]) * ss[0] + _mag(xs[0]) * ss[1]
    if op == "div":
        return val.abs() + (ss[0] + val.abs() * ss[1]) / _mag(xs[1])
    if op in ("plus_mult", "minus_mult"):
        return (val.abs() + ss[0] + _mag(xs[2]) * ss[1]
                + _mag(xs[1]) * ss[2])
    if op == "where":
        return val.abs() + ref.eval_node("where", [xs[0], *ss[1:]], {})
    return _smooth_scale(op, xs, ss, val, attrs)


def _program_scales(cplan, read, outer_mm=None):
    """(values, bounds) of every program node; ``read(nid)`` gives bound
    inputs (exact, s = 0); ``outer_mm`` = (nid, value, bound) stands in for
    the Outer template's per-block product."""
    from repro_torch.kernels import ref
    vals, scales = {}, {}

    def get(kind, r):
        if kind == "n":
            return vals[r], scales[r]
        return (read(r) if kind == "b" else r), 0.0

    for (nid, op, ins, _shape, attrs) in cplan.prog:
        if outer_mm is not None and nid == outer_mm[0]:
            vals[nid], scales[nid] = outer_mm[1], outer_mm[2]
            continue
        xs, ss = zip(*[get(k, r) for k, r in ins])
        attrs = dict(attrs)
        vals[nid] = ref.eval_node(op, list(xs), attrs)
        scales[nid] = _op_scale(op, list(xs), list(ss), vals[nid], attrs)
    return lambda nid: get("n" if nid in vals else "b", nid)


def error_scale(cplan, env):
    """Per output element, the size its fp32 rounding is held against: a
    first-order running error bound of the plain computation in units of
    fp32 eps.  Every program value v carries s(v) with |error(v)| <~ eps *
    s(v): inputs and literals are exact (s = 0); each op adds its own
    rounding |v| and carries its inputs' bounds through its partial
    derivatives (|b| s(a) + |a| s(b) for a*b, |A||B| + s(A)|B| + |A|s(B)
    for a matmul, sum |t| + sum s(t) for a sum, |f'(x)| s(x) for a smooth
    f); piecewise-constant ops count as exact.  The template's own
    reduction closes the bound.  Over a BCSR main the same bound is taken
    per non-zero block (:func:`bcsr_error_scale`)."""
    import torch
    from repro_torch.core.cplan import (COL_AGG, COL_T_AGG, FULL_AGG,
                                        NO_AGG, ROW_AGG)
    from repro_torch.kernels.blocksparse import BCSR
    if isinstance(env[cplan.main.nid], BCSR):
        return bcsr_error_scale(cplan, env)
    root = _program_scales(cplan, lambda nid: env[nid])
    if cplan.extra:
        roots = [(cplan.prog_root, cplan.agg_op)] + list(cplan.extra)
        return torch.cat([_reduce_scale(op, *root(r), "full").reshape(1, 1)
                          for r, op in roots])
    v, s = root(cplan.prog_root)
    if cplan.variant == NO_AGG:
        return s if _is_t(s) else torch.zeros_like(v)
    if cplan.variant == COL_T_AGG:
        c, sc = root(cplan.close_nid)
        return _matmul_scale(c.T, sc.T if _is_t(sc) else sc, v, s)
    axis = {FULL_AGG: "full", ROW_AGG: "row", COL_AGG: "col"}[cplan.variant]
    return _reduce_scale(cplan.agg_op, v, s, axis)


def bcsr_error_scale(cplan, env, chunk: int = 4096):
    """:func:`error_scale` of an Outer ``right_mm`` / ``full_agg`` CPlan
    over a BCSR main, block by block in chunks of ``chunk`` blocks (the
    values are as large as X): the per-block product U_b V_bᵀ carries
    |U_b||V_b|ᵀ, the chain its ops' bounds, and the close sums |v| + s
    against |closer| per block row (right_mm) or over everything
    (full_agg)."""
    import torch
    from repro_torch.core.cplan import FULL_AGG, RIGHT_MM
    from repro_torch.kernels import ops
    from repro_torch.kernels.blocksparse import BCSR
    X = env[cplan.main.nid]
    bs, (m, n) = X.bs, X.shape
    kind = {b.kind: b.nid for b in cplan.binds}
    fu, fv = env[kind["factor_u"]], env[kind["factor_v"]]
    mm = next(nid for (nid, op, *_r) in cplan.prog if op == "matmul")
    if cplan.variant == RIGHT_MM:
        closer = ops._as_dense(env[cplan.close_nid])
        closer = (closer.T if cplan.close_tb else closer).abs()
        out = torch.zeros((m // bs, bs, closer.shape[1]),
                          dtype=closer.dtype, device=closer.device)
    elif cplan.variant == FULL_AGG and cplan.agg_op in ("sum", "min",
                                                        "max"):
        parts = []
    else:
        raise NotImplementedError(f"error scale of {cplan.variant}")
    for c0 in range(0, X.nblocks, chunk):
        sub = BCSR(X.data[c0:c0 + chunk], X.rows[c0:c0 + chunk],
                   X.cols[c0:c0 + chunk], X.shape, bs)
        ub = ops._gather_blocks(fu, sub.rows, bs, 0)
        vb = ops._gather_blocks(fv, sub.cols, bs, 0).transpose(1, 2)
        root = _program_scales(cplan, ops._block_env(cplan, env, sub),
                               (mm, torch.bmm(ub, vb),
                                torch.bmm(ub.abs(), vb.abs())))
        v, s = root(cplan.prog_root)
        s = s if _is_t(s) else torch.zeros_like(v)
        if cplan.variant == RIGHT_MM:
            cb = ops._gather_blocks(closer, sub.cols, bs, 0)
            out.index_add_(0, sub.rows.long(), torch.bmm(v.abs() + s, cb))
        elif cplan.agg_op == "sum":
            parts.append((v.abs() + s).sum())
        else:
            parts.append(torch.stack([
                ops._block_agg(v, cplan.agg_op).reshape(()), s.max()]))
    if cplan.variant == RIGHT_MM:
        return out.reshape(m, -1)
    if cplan.agg_op == "sum":
        return torch.stack(parts).sum().reshape(1, 1)
    p = torch.stack(parts)
    return (ops._block_agg(p[:, 0], cplan.agg_op).abs()
            + p[:, 1].max()).reshape(1, 1)


#: row-wise CPlans over more rows than this are held to the limit in
#: chunks of this many rows (the plain version and the error scale of a
#: 10^7 x 100 output would need tens of GB at once)
MEASURE_ROWS = 1_000_000


def measure(cplan, env, got, label: str) -> tuple[float, float]:
    """(max |got - plain|, its largest share of the per-element limit);
    raises on a shape or non-finite mismatch.  A ``no_agg`` / ``row_agg``
    CPlan over a dense main of more than MEASURE_ROWS rows is measured in
    chunks of rows: each output row depends on its own rows only."""
    import torch
    from repro_torch.core.cplan import NO_AGG, ROW_AGG
    m = cplan.main.shape[0]
    main = env[cplan.main.nid]
    if m <= MEASURE_ROWS or cplan.extra or not isinstance(
            main, torch.Tensor) or cplan.variant not in (NO_AGG, ROW_AGG):
        return _measure(cplan, env, got, label)
    if tuple(got.shape[:1]) != (m,):
        raise AssertionError(f"{label}: shape {tuple(got.shape)}")
    err = share = 0.0
    for r0 in range(0, m, MEASURE_ROWS):
        rows = slice(r0, r0 + MEASURE_ROWS)
        sub = {nid: (t[rows] if t.shape[0] == m else t)
               for nid, t in env.items()}
        e, sh = _measure(cplan, sub, got[rows], f"{label} rows {r0}:")
        err, share = max(err, e), max(share, sh)
    return err, share


def _measure(cplan, env, got, label: str) -> tuple[float, float]:
    import torch
    from repro_torch.kernels import ops
    exp = ops.execute(cplan, env, kernels="never")
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"plain {tuple(exp.shape)}")
    fin = torch.isfinite(exp)
    if not bool(torch.equal(torch.isfinite(got), fin)):
        raise AssertionError(f"{label}: non-finite values differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (got[fin] - exp[fin]).abs()
    scale = error_scale(cplan, env)
    if tuple(scale.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: error scale {tuple(scale.shape)}")
    limit = KERNEL_ULPS * EPS32 * scale[fin].clamp_min(
        torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / limit).max())


def compare(cplan, env, label: str) -> tuple[float, float]:
    """Kernel vs plain on the same CUDA tensors: (max |error|, its share of
    the limit); raises when any element is over its limit."""
    from repro_torch.kernels import ops
    got = ops.execute(cplan, env, kernels="cuda")
    err, share = measure(cplan, env, got, label)
    if not share <= 1.0:
        raise AssertionError(f"{label}: max |kernel - plain| = {err:.3e}, "
                             f"{share:.3g} x its limit")
    return err, share


def planted(src, fold: bool = False, group: bool = False):
    """``src`` built with a planted fault: the Cell kernel's fold and
    ``rk::combine`` drop the middle partial, the Row ``row_agg`` variant the middle element of every
    row (tile layout) or the middle lane's partial (warp layout), the Row
    tile layout's ``col_t_agg`` close the middle row slice of each CTA, the
    Outer ``right_mm`` skips the middle block of every block row; with ``fold``, the Outer ``right_mm`` fold drops the middle
    piece of every row of two or more pieces instead; with ``group``, the
    Cell kernel's vector walk drops the second cell of every group instead.
    A source with no such step is returned as is."""
    if group:
        return dataclasses.replace(src, text=PLANT_GROUP + src.text) \
            if getattr(src, "walk", "") == "vector" else src
    if fold:
        return dataclasses.replace(src, text=PLANT_FOLD + src.text) \
            if src.template == "outer" and not src.elems else src
    return dataclasses.replace(src, text=PLANT + src.text) \
        if src.elems or src.template == "outer" or \
        (src.template, src.variant) == ("row", "row_agg") else src


@contextlib.contextmanager
def planted_fault(fold: bool = False, group: bool = False):
    """Every reducing kernel launched inside runs its planted build (with
    ``fold``: the fold fault; with ``group``: every vector-walk Cell
    kernel its group fault)."""
    from repro_torch.kernels import cuda_src
    orig = cuda_src.source_for
    cuda_src.source_for = lambda cp, bs=None: planted(orig(cp, bs), fold,
                                                      group)
    try:
        yield
    finally:
        cuda_src.source_for = orig


def trace_rel(objs, ref_objs) -> float:
    """Largest relative difference of two objective traces; infinite when
    their lengths differ or a value is not finite."""
    if len(objs) != len(ref_objs) or not all(
            math.isfinite(v) for v in list(objs) + list(ref_objs)):
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(objs, ref_objs))


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps``
    back-to-back calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


#: idle host time at each end of a profiler step that is read: without
#: it, the first calls' kernels could be missing from the trace
PROFILE_PAD_S = 0.05


def device_ms(fn, reps: int = 10, names: list | None = None):
    """Device time per call from a ``torch.profiler`` trace: the self
    device time of every kernel the calls launched, summed, over ``reps``;
    None when the trace holds no device time.  ``names``, where given,
    receives (kernel name, launches per call) of every kernel traced.  A first profiler step runs
    ``fn`` once and is discarded, and the step that is read is padded with
    ``PROFILE_PAD_S`` of idle time at each end.  A kernel launched a number
    of times that is not a multiple of ``reps`` is logged: the trace lost
    some of its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    lost = [f"{e.key[:40]} x{e.count}" for e in events if e.count % reps]
    if lost:
        log(f"[time] launches missing from a {reps}-call trace: {lost}")
    if names is not None:
        names += [(e.key, e.count / reps) for e in events]
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / 1e3 / reps if total_us > 0 else None


def bound_ms(cplan, env, out) -> tuple[float, str]:
    """Least time for the same work: each distinct input read once and the
    output written once over HBM bandwidth, or the program's fp32 flops
    over the fp32 peak — the larger, and which one it is."""
    from repro_torch.kernels.blocksparse import BCSR
    if isinstance(env[cplan.main.nid], BCSR):
        return outer_bound_ms(cplan, env, out)
    seen, nbytes = set(), out.numel() * 4
    for t in env.values():
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    rows = cplan.main.shape[0]
    flops = 0
    for (_nid, op, ins, shape, attrs) in cplan.prog:
        cells = shape[0] * shape[1]
        if op == "matmul":
            side = next(b.shape for b in cplan.binds
                        if ("b", b.nid) == ins[1])
            inner = side[1] if dict(attrs).get("tb") else side[0]
            flops += 2 * cells * inner
        else:
            flops += cells
    if cplan.variant == "col_t_agg":
        flops += 2 * rows * out.numel()
    t_bytes, t_flops = nbytes / HBM_BW * 1e3, flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def outer_bound_ms(cplan, env, out) -> tuple[float, str]:
    """:func:`bound_ms` of an Outer CPlan over a BCSR main, counting what
    this matrix needs: bytes are the nb non-zero blocks of X with their
    block indices and block-row pointer, each distinct dense operand (U,
    V, closer, sides) and the output; flops per block are 2 bs² r for
    U_b V_bᵀ, 2 bs² k for the right_mm close and bs² per chain op."""
    X = env[cplan.main.nid]
    nb, bs = X.nblocks, X.bs
    nbytes = (nb * bs * bs + 2 * nb + X.rowptr.numel()) * 4 \
        + out.numel() * 4
    seen = set()
    for b in cplan.binds[1:]:
        t = env[b.nid]
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    r = next(b.shape[1] for b in cplan.binds if b.kind == "factor_u")
    ops_per_cell = sum(op != "matmul" for (_n, op, *_r) in cplan.prog)
    k = out.shape[1] if cplan.variant == "right_mm" else 0
    flops = nb * bs * bs * (2 * r + 2 * k + ops_per_cell)
    t_bytes, t_flops = nbytes / HBM_BW * 1e3, flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def sm_clock_mhz() -> tuple[float, float]:
    """The card's current and maximum SM clocks (MHz), from nvidia-smi."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    cur, top = r.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def cuobjdump_path() -> str:
    """The CUDA toolkit's cuobjdump (beside nvcc where it is not on PATH)."""
    import shutil
    from repro_torch.kernels import build
    return shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))


def sass_loop_counts(src) -> dict:
    """Static SASS counts of a built Cell kernel (``cuobjdump -sass`` of
    its library): per kernel function, its instructions and those of its
    largest loop (the span from a backward branch's target to the branch,
    NOPs left out) — for the vector walk the loop of U groups in flight,
    so loop / (4 U) is the instructions a cell issues there.  Out-of-line
    slow paths (an IEEE division's) lie outside the span and are not
    counted."""
    import re
    from repro_torch.kernels import build
    text = subprocess.run([cuobjdump_path(), "-sass",
                           str(build.library_path(src))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        insts, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            insts.append((addr, m.group(2).strip()))
        loop = 0
        for addr, ins in insts:
            t = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
            if not t:
                continue
            dst = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if dst is not None and dst <= addr:
                loop = max(loop, sum(1 for a, i in insts if dst <= a <= addr
                                     and not i.startswith("NOP")))
        out[name] = {"insts": sum(1 for _a, i in insts
                                  if not i.startswith("NOP")),
                     "loop": loop}
    return out


def issue_floor(src, cells: int, busy=None) -> dict:
    """The issue floor of a Cell kernel: the SASS instructions a cell
    issues in the kernel's largest loop (:func:`sass_loop_counts`; the
    vector walk's loop of U groups of 4 cells, the scalar walk's loop of
    one cell), times the cells, over the SMs x 4 warp schedulers x 32
    lanes, at the SM clock nvidia-smi reports while ``busy`` runs on the
    card (a call of the kernel, repeated for about half a second) and at
    the card's maximum."""
    import threading
    import torch
    counts = sass_loop_counts(src)
    fn = max(counts, key=lambda k: counts[k]["loop"])
    per_cell = counts[fn]["loop"] / ((getattr(src, "group", 0) or 1)
                                     * (getattr(src, "unroll", 0) or 1))
    clocks = []
    reader = threading.Thread(
        target=lambda: (time.sleep(0.2), clocks.append(sm_clock_mhz())))
    reader.start()
    t0 = time.perf_counter()
    while busy is not None and time.perf_counter() - t0 < 0.5:
        for _ in range(100):
            busy()
    torch.cuda.synchronize()
    reader.join()
    cur, top = clocks[0]
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    return {"function": fn[:60], "loop_insts": counts[fn]["loop"],
            "insts": counts[fn]["insts"], "per_cell": per_cell,
            "clock_mhz": cur, "max_clock_mhz": top,
            "floor_ms": cells * per_cell / (lanes * cur * 1e6) * 1e3,
            "floor_max_clock_ms": cells * per_cell / (lanes * top * 1e6)
            * 1e3}


def profile_run(label: str, fn) -> None:
    """Where the time goes: one more run of ``fn`` (plans already cached)
    under ``torch.profiler``; device busy time per kernel name and the
    idle share of the host-clock wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)    # tracer start-up, discarded
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
        prof.step()
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


# --------------------------------------------------------------------------
# ALS-CG helpers
# --------------------------------------------------------------------------

def padded(shape, bs: int = ALS_BS) -> tuple[int, int]:
    return tuple(-(-d // bs) * bs for d in shape)


def netflix_like(shape, seed: int = 0):
    """A BCSR ratings matrix built on the card from a seeded
    ``torch.Generator``, block row by block row: ``shape`` padded to
    ALS_BS, each block present with probability ALS_DENSITY (block (0, 0)
    always), values a planted rank-8 product plus 0.1 noise, zero in the
    padding rows and columns (what ``data.ratings`` draws with numpy,
    which would need a dense m x n array)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    bs = ALS_BS
    (m0, n0), (m, n) = shape, padded(shape)
    mb, nbc = m // bs, n // bs
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand((mb, nbc), generator=g, device="cuda") < ALS_DENSITY
    mask[0, 0] = True
    rows, cols = torch.nonzero(mask, as_tuple=True)      # row-major
    Ut = torch.randn((m, 8), generator=g, device="cuda") / math.sqrt(8)
    Vt = torch.randn((n, 8), generator=g, device="cuda") / math.sqrt(8)
    Ut[m0:] = 0.0
    Vt[n0:] = 0.0
    live_r = (torch.arange(m, device="cuda") < m0).float().reshape(mb, bs, 1)
    live_c = (torch.arange(n, device="cuda") < n0).float().reshape(nbc, 1,
                                                                    bs)
    data = torch.empty((rows.numel(), bs, bs), device="cuda")
    ptr = torch.searchsorted(rows, torch.arange(mb + 1, device="cuda"))
    ptr = ptr.tolist()
    step = 256                                 # block rows per chunk
    for r0 in range(0, mb, step):
        a, b = ptr[r0], ptr[min(r0 + step, mb)]
        if a == b:
            continue
        ri, ci = rows[a:b], cols[a:b]
        blk = torch.bmm(Ut.reshape(mb, bs, 8)[ri],
                        Vt.reshape(nbc, bs, 8)[ci].transpose(1, 2))
        blk += 0.1 * torch.randn(blk.shape, generator=g, device="cuda")
        data[a:b] = blk * live_r[ri] * live_c[ci]
    return BCSR(data, rows.to(torch.int32), cols.to(torch.int32), (m, n),
                bs)


def outer_case_env(case, vals, names):
    """An Outer sweep case's numpy operands on the card (X as BCSR)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    return {nid: (BCSR.from_dense(torch.tensor(vals[n], device="cuda"),
                                  case.bs) if n == "X"
                  else torch.tensor(vals[n], device="cuda"))
            for nid, n in names.items()}


def meta_bcsr(shape):
    """A BCSR of ``shape`` at ALS_DENSITY with no data (planning needs
    shapes and block sparsity only)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    bs = ALS_BS
    nb = max(1, round(ALS_DENSITY * (shape[0] // bs) * (shape[1] // bs)))
    idx = torch.empty(nb, dtype=torch.int32, device="meta")
    return BCSR(torch.empty((nb, bs, bs), device="meta"), idx, idx, shape,
                bs)


def als_cplans(X, XT, rank: int = ALS_RANK):
    """The Outer CPlans of one ALS iteration: ``_wsq_mm`` over X (the U
    update), over Xᵀ (the V update) and ``_loss_terms``; X may be a
    :func:`meta_bcsr`."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    m, n = X.shape
    U = torch.empty((m, rank), device="meta")
    V = torch.empty((n, rank), device="meta")
    out = []
    with FusionContext():
        for label, region, args in (("_wsq_mm U-update", als_cg._wsq_mm,
                                     (X, U, V)),
                                    ("_wsq_mm V-update", als_cg._wsq_mm,
                                     (XT, V, U)),
                                    ("_loss_terms", als_cg._loss_terms,
                                     (X, U, V))):
            (cp,) = compile_plan(region.trace(*args).plan().eplan).cplans()
            out.append((label, cp))
    return out


def als_env(cplan, Xs, gen, rank: int = ALS_RANK):
    """Operands of an ALS CPlan on the card: the BCSR main, U and V drawn
    as the algorithm draws its start (0.1 x normal)."""
    import torch
    env = {}
    for b in cplan.binds:
        env[b.nid] = Xs if b.kind == "main" else 0.1 * torch.randn(
            tuple(b.shape), generator=gen, device="cuda")
    return env


def time_part(label, kname, cp, env, kernel, plain, out,
              library=None) -> dict:
    """One main-path CPlan's times (CUDA events and device, kernel and
    plain, and ``library``: one PyTorch call computing the same function,
    where there is one) beside its bound, logged as a ``[time]`` line, with
    the kernels one call launched on the card (a Cell call of this tree:
    exactly one Cell kernel, else it raises) and, for a Cell CPlan of
    MEASURE_ROWS cells or more, its issue floor (a ``[sass]`` line)."""
    from repro_torch.kernels import cuda_src
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    traced = []
    dev_ms, dev_plain_ms = device_ms(kernel, names=traced), device_ms(plain)
    b_ms, b_by = bound_ms(cp, env, out)
    lib = ""
    part = {"region": label, "variant": cp.variant,
            "layout": layout_name(cp) if kname in ("row", "cell") else "-",
            "binds": [list(b.shape) for b in cp.binds], "ms": ms,
            "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": dev_plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}
    if library is not None:
        part["library_ms"] = time_ms(library)
        part["library_device_ms"] = device_ms(library)
        lib = (f" library {part['library_ms']:.4f} ms (device "
               f"{part['library_device_ms']})")
    part["device_kernels"] = [[k[:60], c] for k, c in traced]
    cells = cp.main.shape[0] * cp.main.shape[1]
    if kname == "cell" and cells >= MEASURE_ROWS:
        fl = issue_floor(cuda_src.source_for(cp), cells, kernel)
        part["issue_floor"] = fl
        log(f"[sass] {label} {cp.variant}: {fl['loop_insts']} SASS "
            f"instructions in the loop of {fl['function'][:40]}, "
            f"{fl['per_cell']:.2f} a cell ({fl['insts']} in the kernel); "
            f"issue floor {fl['floor_ms']:.4f} ms at {fl['clock_mhz']:g} "
            f"MHz under load, {fl['floor_max_clock_ms']:.4f} ms at "
            f"{fl['max_clock_mhz']:g} MHz; byte bound {b_ms:.4f} ms")
    one_launch = kname == "cell" and getattr(cuda_src.source_for(cp),
                                             "walk", "")
    if one_launch and not (
            len(traced) == 1 and traced[0][1] == 1
            and "cell_" in traced[0][0]):
        raise AssertionError(f"{label}: a Cell call launched {traced}, not "
                             f"one Cell kernel")
    per_call = " + ".join(f"{k.split('(')[0][:40]} x{c:g}"
                          for k, c in traced)
    log(f"[time] {label:22s} {kname:5s} {part['layout']:4s} "
        f"{cp.variant:9s} kernel {ms:.4f} ms "
        f"(device {dev_ms}) plain {plain_ms:.4f} ms (device "
        f"{dev_plain_ms}){lib} bound {b_ms:.4f} ms ({b_by}); per call on "
        f"the card: {per_call}")
    return part


def add_part(rec: dict, part: dict) -> None:
    for key in ("ms", "plain_ms", "bound_ms"):
        rec[key] += part[key]
    rec["bound_by"][part["bound_by"]] = \
        rec["bound_by"].get(part["bound_by"], 0) + 1
    rec["parts"].append(part)


def new_record() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
            "parts": []}


def _row_norms_call(cp, env):
    import torch
    X = env[cp.main.nid]
    return lambda: torch.einsum("ij,ij->i", X, X)


def _sum_sq_call(cp, env):
    import torch
    if [op for (_n, op, *_r) in cp.prog] != ["pow2"] or cp.agg_op != "sum":
        raise AssertionError(f"{cp.prog}: not a sum of squares")
    x = env[cp.main.nid].reshape(-1)
    return lambda: torch.dot(x, x)


#: CPlans that one PyTorch call also computes: (label, kernel, variant) ->
#: that call on the CPlan's operands (Σw², ΣB²: the dot product of the
#: flattened operand with itself)
LIBRARY_CALLS = {
    ("kmeans _sq_rowsums", "row", "row_agg"): _row_norms_call,
    ("_objective_full", "cell", "full_agg"): _sum_sq_call,
    ("_objective_full:vjp", "cell", "full_agg"): _sum_sq_call,
    ("mlogreg _nll_obj_reg", "cell", "full_agg"): _sum_sq_call,
    ("mlogreg _nll_obj_reg:vjp", "cell", "full_agg"): _sum_sq_call,
}


def dense_times(main_cps, envs, per_kernel=None) -> dict:
    """A dense main path's CPlans timed, each added to its kernel's record
    in ``per_kernel`` (new records when None); returns the records."""
    from repro_torch.kernels import cellwise, multiagg, ref, rowwise
    wrappers = {"cell": cellwise.cell, "magg": multiagg.multiagg,
                "row": rowwise.row}
    if per_kernel is None:
        per_kernel = {k: new_record() for k in KERNELS}
    for (region, cp), env in zip(main_cps, envs):
        kname = kernel_name(cp)
        lib = LIBRARY_CALLS.get((region, kname, cp.variant))
        add_part(per_kernel[kname], time_part(
            region, kname, cp, env, lambda: wrappers[kname](cp, env),
            lambda: ref.execute_dense(cp, env), ref.execute_dense(cp, env),
            lib(cp, env) if lib else None))
    return per_kernel


def outer_times(cps, envs) -> dict:
    """The ALS CPlans timed: the Outer kernel's record."""
    from repro_torch.kernels import outerprod
    rec = new_record()
    for (label, cp), env in zip(cps, envs):
        part = time_part(label, "outer", cp, env,
                         lambda: outerprod.outer(cp, env),
                         lambda: outerprod.outer_plain(cp, env),
                         outerprod.outer_plain(cp, env))
        part["nblocks"] = env[cp.main.nid].nblocks
        add_part(rec, part)
    return rec


def l2svm_data(m: int):
    """The L2SVM main path's X (m, N_MAIN) and labels from a planted w,
    drawn on the card from a seeded ``torch.Generator``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    w_true = torch.randn((N_MAIN, 1), generator=g, device="cuda")
    noise = torch.randn((m, 1), generator=g, device="cuda")
    y = torch.where(X @ w_true + 0.5 * noise >= 0, 1.0, -1.0)
    return X, y


# --------------------------------------------------------------------------
# the four dense algorithms: MLogReg, GLM, KMeans, the autoencoder
# --------------------------------------------------------------------------

class AlgoPath(NamedTuple):
    """One dense algorithm's main path: its fused regions at the path's
    shapes (region, meta args, plan the backward?), its data drawn on the
    card, its run, and the check of what the run returns."""
    name: str
    depth: str
    regions: list
    data: Callable       # () -> operands on the card
    run: Callable        # (operands, **kw) -> (parameters, trace)
    check: Callable      # (operands, parameters) -> None; raises


def mlogreg_data(m: int):
    """X (m, N_MAIN) and one-hot labels (m, MLR_K) from a planted B plus
    0.5 noise on the logits (data.classification's model), drawn on the
    card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    B = torch.randn((N_MAIN, MLR_K), generator=g, device="cuda")
    noise = torch.randn((m, MLR_K), generator=g, device="cuda")
    idx = torch.argmax(X @ B + 0.5 * noise, dim=1, keepdim=True)
    Y = torch.zeros((m, MLR_K), device="cuda").scatter_(1, idx, 1.0)
    return X, Y


def glm_data(m: int):
    """X (m, N_MAIN) and binary labels from a planted probit: y = 1 where
    X w + N(0, 1) > 0, w ~ N(0, 1/N_MAIN) (so P(y = 1) = Φ(X w)), drawn
    on the card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    w = torch.randn((N_MAIN, 1), generator=g, device="cuda") / math.sqrt(
        N_MAIN)
    noise = torch.randn((m, 1), generator=g, device="cuda")
    return X, (X @ w + noise > 0).to(torch.float32)


def kmeans_data(m: int):
    """X (m, N_MAIN) around KM_K planted centres (4 x N(0, 1)) with unit
    noise, drawn on the card (seeded); C0 = X's first KM_K rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(3)
    centres = 4.0 * torch.randn((KM_K, N_MAIN), generator=g, device="cuda")
    asg = torch.randint(0, KM_K, (m,), generator=g, device="cuda")
    X = centres[asg]
    X += torch.randn((m, N_MAIN), generator=g, device="cuda")
    return X, X[:KM_K].clone()


def images_data(m: int):
    """(m, AE_N) in [0, 1), a quarter of the cells non-zero (what
    data.images draws with numpy), drawn on the card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(4)
    keep = torch.rand((m, AE_N), generator=g, device="cuda") < 0.25
    return (keep * torch.rand((m, AE_N), generator=g, device="cuda"),)


def finite(label: str, t, shape) -> None:
    import torch
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{label}: not a finite {tuple(shape)} tensor "
                             f"(got {tuple(t.shape)})")


def kmeans_assignment(X, C):
    """(rows with no centroid at their minimum distance, max |row sum of
    the tie-split assignment - 1|) of one KMeans assignment step on the
    card: the fused row minimum against torch's D, as ``kmeans.run``
    builds them."""
    import torch
    from repro_torch.algos import kmeans
    from repro_torch.core import FusionContext
    with FusionContext():
        xsq = kmeans._sq_rowsums(X)
        XC = X @ C.T
        csq = torch.sum(C * C, dim=1).reshape(1, -1)
        dmin = kmeans._min_dist(XC, xsq, csq)
    A = (xsq - 2.0 * XC + csq == dmin).to(torch.float32)
    hits = A.sum(dim=1, keepdim=True)
    sums = (A / hits).sum(dim=1)
    return int((hits == 0).sum()), float((sums - 1.0).abs().nan_to_num(
        math.inf).max())


def check_kmeans(ops, C) -> None:
    X, C0 = ops
    finite("kmeans C", C, (KM_K, N_MAIN))
    for label, Cs in (("C0", C0), ("the final C", C)):
        missed, off = kmeans_assignment(X, Cs)
        log(f"[kmeans] assignment at {label}: {missed} rows without a "
            f"match of the fused minimum, max |row sum - 1| {off:.3e}")
        if missed or not off <= 4 * EPS32:
            raise AssertionError(f"kmeans: assignment rows at {label} do "
                                 f"not sum to 1")


def check_autoencoder(_ops, params) -> None:
    Ws, bs = params
    dims = (AE_N, AE_H1, AE_H2, AE_H1, AE_N)
    for i, (W, b) in enumerate(zip(Ws, bs)):
        finite(f"autoencoder W{i + 1}", W, (dims[i], dims[i + 1]))
        finite(f"autoencoder b{i + 1}", b, (1, dims[i + 1]))


def algo_paths(m: int) -> list:
    """The four dense algorithms' main paths at m rows (the autoencoder
    at AE_ROWS): regions, data, run and checks."""
    from repro_torch.algos import autoencoder, glm, kmeans, mlogreg
    n, k = N_MAIN, MLR_K
    X, col = meta(m, n), meta(m, 1)
    Xb = meta(AE_BATCH, AE_N)
    h1, h2 = AE_H1, AE_H2
    weights = (meta(AE_N, h1), meta(1, h1), meta(h1, h2), meta(1, h2),
               meta(h2, h1), meta(1, h1), meta(h1, AE_N), meta(1, AE_N))
    return [
        AlgoPath(
            "mlogreg", f"k = {k}, lambda {LAM:g}, {MLR_OUTER} outer x "
            f"{MLR_INNER} CG iterations (reference: 10 x 20)",
            [(mlogreg._probs, (X, meta(n, k)), False),
             (mlogreg._nll_obj_reg, (X, meta(n, k), meta(m, k), meta(1, 1)),
              True),
             (mlogreg._hvp, (X, meta(n, k), meta(m, k)), False)],
            lambda: mlogreg_data(m),
            lambda ops, **kw: mlogreg.run(*ops, lam=LAM, max_outer=MLR_OUTER,
                                          max_inner=MLR_INNER, **kw),
            lambda ops, B: finite("mlogreg B", B, (n, k))),
        AlgoPath(
            "glm", f"binomial probit, lambda {LAM:g}, {GLM_OUTER} outer x "
            f"{GLM_INNER} CG iterations (reference: 8 x 10)",
            [(glm._link_chain, (col, col), False),
             (glm._deviance, (col, col), False),
             (glm._wz, (X, col, col), False),
             (glm._wxv, (X, col, meta(n, 1)), False)],
            lambda: glm_data(m),
            lambda ops, **kw: glm.run(*ops, lam=LAM, max_outer=GLM_OUTER,
                                      max_inner=GLM_INNER, **kw),
            lambda ops, beta: finite("glm beta", beta, (n, 1))),
        AlgoPath(
            "kmeans", f"k = {KM_K}, C0 = X's first {KM_K} rows, "
            f"{KM_ITERS} iterations (reference: 20)",
            [(kmeans._sq_rowsums, (X,), False),
             (kmeans._min_dist, (meta(m, KM_K), col, meta(1, KM_K)), False)],
            lambda: kmeans_data(m),
            lambda ops, **kw: kmeans.run(*ops, max_iter=KM_ITERS, **kw),
            check_kmeans),
        AlgoPath(
            "autoencoder", f"X {AE_ROWS} x {AE_N}, H1 {h1}, H2 {h2}, batch "
            f"{AE_BATCH}, {AE_STEPS} SGD steps (reference: one epoch)",
            [(autoencoder._recon_loss, (Xb, *weights), True)],
            lambda: images_data(AE_ROWS),
            lambda ops, **kw: autoencoder.run(
                ops[0][:AE_STEPS * AE_BATCH], h1=h1, h2=h2, batch=AE_BATCH,
                **kw),
            check_autoencoder),
    ]


def cell_checks(label, cp, env, fault: bool = False) -> list[str]:
    """A main-path Cell CPlan on the card: a reducing one gives the same
    bits twice; with ``fault``, its planted group fault (vector walk) must
    fail the kernel check.  Returns what failed."""
    import torch
    from repro_torch.kernels import ops
    failed = []
    if cp.variant != "no_agg":
        a = ops.execute(cp, env, kernels="cuda")
        same = bool(torch.equal(a, ops.execute(cp, env, kernels="cuda")))
        log(f"[check] main path {label} {cp.variant}: two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            failed.append(f"{label} {cp.variant}: reruns differ")
    if fault and layout_name(cp) == "vec":
        with planted_fault(group=True):
            got = ops.execute(cp, env, kernels="cuda")
        err, share = measure(cp, env, got, f"planted group {label}")
        del got
        log(f"[check] planted fault (one cell of every group dropped) main "
            f"path {label} {cp.variant}: max|kernel-plain| {err:.3e} = "
            f"{share:.3g} x limit")
        if not share > 1.0:
            failed.append(f"planted group fault in {label} passed the "
                          f"kernel check")
    return failed


def cell_sweep_card_checks(planned, gen) -> None:
    """Every reducing Cell sweep CPlan at M_SWEEP rows gives the same bits
    twice (one launch, the fold in CTA order); a vector-walk operand that
    is not 16-byte aligned raises."""
    import torch
    from repro_torch.kernels import ops
    for c, m, n, cp, _names in planned:
        if c.template != "cell" or cp.variant == "no_agg" or m != M_SWEEP:
            continue
        env = random_env(cp, gen)
        same = bool(torch.equal(ops.execute(cp, env, kernels="cuda"),
                                ops.execute(cp, env, kernels="cuda")))
        log(f"[check] {c.name} ({layout_name(cp)}) at {m}x{n}: two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{c.name}: reruns differ")
    c, m, n, cp, _names = next(p for p in planned
                               if p[0].name == "cell/no_agg_row_side"
                               and p[1] == M_SWEEP)
    env = random_env(cp, gen)
    X = env[cp.main.nid]
    shifted = torch.empty(X.numel() + 1, device="cuda")[1:].view(X.shape)
    shifted.copy_(X)
    try:
        ops.execute(cp, {**env, cp.main.nid: shifted}, kernels="cuda")
    except ValueError as e:
        log(f"[check] {c.name}: an operand 4 bytes off a 16-byte boundary "
            f"raises: {e}")
    else:
        raise AssertionError("a misaligned vector-walk operand ran")


def path_cplans(path) -> list:
    return region_cplans(path.regions, path.name + " ")


def algo_phase(path, cps, counters, launches, main_err, per_kernel) -> None:
    """One dense algorithm at the main path's width: the run with
    ``kernels="cuda"`` (counters set to 0 just before it and read just
    after, added into ``launches``), its checks, its trace against
    ``kernels="never"``, a planted fault and the hand baseline, a profile,
    then its CPlans against plain and timed (into ``main_err`` and
    ``per_kernel``)."""
    import torch
    name = path.name
    t_phase = time.perf_counter()
    ops = path.data()
    torch.cuda.synchronize()
    shapes = [tuple(t.shape) for t in ops]
    log(f"[{name}] data {shapes} fp32 drawn on the card in "
        f"{time.perf_counter() - t_phase:.1f} s; {path.depth}")
    run = lambda **kw: path.run(ops, **kw)
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    params, trace = run(kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    counts = {k: mod.launches for k, mod in counters.items()}
    for k, c in counts.items():
        launches[k] += c
    log(f"[{name}] run kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches {json.dumps(counts)}")
    log(f"[{name}] trace (kernels=cuda): {trace}")
    needed = sorted({kernel_name(cp) for _l, cp in cps})
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name} main path never launched: {missing}")
    path.check(ops, params)
    del params
    t0 = time.perf_counter()
    _p, trace_plain = run(kernels="never")
    torch.cuda.synchronize()
    log(f"[{name}] kernels=never: {time.perf_counter() - t0:.2f} s; trace "
        f"{trace_plain}")
    with planted_fault():
        _p, trace_fault = run(kernels="cuda")
    _p, trace_hand = run(mode="hand")
    del _p
    rel, rel_fault = trace_rel(trace, trace_plain), trace_rel(trace_fault,
                                                              trace_plain)
    rel_hand = trace_rel(trace_hand, trace_plain)
    log(f"[{name}] planted fault (one partial dropped in every reducing "
        f"kernel): trace {trace_fault}")
    log(f"[{name}] hand torch baseline trace {trace_hand}")
    log(f"[{name}] max relative trace difference vs never: kernels "
        f"{rel:.3e}, planted {rel_fault:.3e} (tolerance {TRACE_RTOL:g}); "
        f"hand {rel_hand:.3e} (tolerance {HAND_RTOL:g})")
    failed = []
    if not rel <= TRACE_RTOL:
        failed.append(f"{name}: traces of kernels=cuda and never disagree")
    if not rel_fault > TRACE_RTOL:
        failed.append(f"planted fault passed the {name} trace check")
    if not rel_hand <= HAND_RTOL:
        failed.append(f"{name}: the hand baseline disagrees")
    profile_run(f"{name} kernels=cuda, {path.depth}",
                lambda: run(kernels="cuda"))

    # the path's CPlans at its shapes, against plain, then timed
    gen = torch.Generator(device="cuda").manual_seed(2468)
    shared = {tuple(ops[0].shape): ops[0]}     # X: the path's data matrix
    envs = []
    for label, cp in cps:
        env = random_env(cp, gen, shared)
        kname = kernel_name(cp)
        err, share = compare(cp, env, f"main-path {label} {cp.ttype.name} "
                                      f"{cp.variant}")
        main_err[kname] = max(main_err[kname], err)
        envs.append(env)
        log(f"[check] main path {label:28s} {kname:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} "
            f"binds {[tuple(b.shape) for b in cp.binds]} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        if kname == "cell":
            failed += cell_checks(label, cp, env, fault=name == "glm")
    dense_times(cps, envs, per_kernel)
    del ops, envs, shared
    torch.cuda.empty_cache()
    log(f"[{name}] phase wall {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def run() -> None:
    import torch
    m_main = M_MAIN

    # 1. environment ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.algos import l2svm
    from repro_torch.kernels import (build, cellwise, cuda_src, multiagg,
                                     ops, outerprod, rowwise, sweep)
    from repro_torch.kernels.blocksparse import BCSR
    counters = {"cell": cellwise, "magg": multiagg, "row": rowwise,
                "outer": outerprod}
    card = card_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} repro_torch {repro_torch.__version__}")
    log(f"[env] device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sweep_runs = []        # (case, m, n)
    for c in sweep.cases():
        for (m, n) in ((33, 7), (33, 1), (M_SWEEP, N_MAIN)):
            if n >= c.min_n:
                sweep_runs.append((c, m, n))
    planned = [(c, m, n, *sweep.fused_cplan(c, m, n))
               for c, m, n in sweep_runs]
    # the Cell kernel over (m,1) domains (and (m,4) ones for the (1,n)
    # side cases) at the row counts that reach every part of its walk:
    # CPlans of (33, n) resized, so their sources are those of (33, n)
    tails = []
    for c in sweep.cases():
        if c.template != "cell" or c.min_n > 1:
            continue
        for n in (1, 4) if c.name in PLANTED_GROUP else (1,):
            cp33, names = sweep.fused_cplan(c, 33, n)
            tails += [(c, m, n, sweep.with_rows(cp33, m), names)
                      for m in TAIL_ROWS]
    main_cps = main_path_cplans(m_main, N_MAIN)
    paths = algo_paths(m_main)
    path_cps = {path.name: path_cplans(path) for path in paths}
    dense_cps = [cp for _r, cp in main_cps] + [
        cp for cps in path_cps.values() for _r, cp in cps]
    sources = {}
    for cp in [p[3] for p in planned + tails] + dense_cps:
        src = cuda_src.source_for(cp)
        sources[src.key] = src
    # the planted-fault builds: the planted sweep cases and the main paths
    for cp in [p[3] for p in planned if p[0].name in PLANTED
               and p[1] == M_SWEEP] + dense_cps:
        src = planted(cuda_src.source_for(cp))
        sources[src.key] = src
    for cp in [p[3] for p in planned if p[0].name in PLANTED_GROUP
               and p[1] == M_SWEEP] + [cp for _r, cp in path_cps["glm"]]:
        src = planted(cuda_src.source_for(cp), group=True)
        sources[src.key] = src
    # the Outer kernel: its sweep, the ALS CPlans at the main path's shape
    # and at the hand baseline's, each sound and planted
    outer_planned = []
    for i, c in enumerate(sweep.outer_cases()):
        vals = sweep.outer_values(c, seed=100 + i)
        sp = BCSR.from_dense(vals["X"], c.bs).block_sparsity
        outer_planned.append((c, vals, *sweep.fused_cplan(
            c, *c.shape, sparsity={"X": sp})))
    outer_srcs = [(c.name, cp, c.bs) for c, _v, cp, _n in outer_planned]
    for shape in (padded(ALS_SHAPE), padded(ALS_HAND_SHAPE)):
        Xm = meta_bcsr(shape)
        outer_srcs += [(label, cp, ALS_BS)
                       for label, cp in als_cplans(Xm, meta_bcsr(shape[::-1]))]
    for name, cp, bs in outer_srcs:
        src = cuda_src.source_for(cp, bs)
        sources[src.key] = src
        if name in PLANTED or not name.startswith("outer/"):
            sources[planted(src).key] = planted(src)
        if name in PLANTED_FOLD or name == "_wsq_mm V-update":
            sources[planted(src, True).key] = planted(src, True)
    t_plan = time.perf_counter() - t0
    build.build_all(sources.values())
    t_build = time.perf_counter() - t0 - t_plan
    log(f"[build] {len(sources)} kernel sources (planning {t_plan:.1f} s), "
        f"nvcc {t_build:.1f} s in parallel, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain: the sweep ---------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {k: 0.0 for k in KERNELS}
    for c, m, n, cp, _names in planned:
        kname = kernel_name(cp)
        if kname != c.template:
            raise AssertionError(f"{c.name}: routed to {kname}")
        err, share = compare(cp, random_env(cp, gen), f"{c.name} at {m}x{n}")
        worst[kname] = max(worst[kname], share)
        log(f"[check] {c.name:30s} {m:>9d}x{n:<3d} {cp.ttype.name:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} max|kernel-plain| "
            f"{err:.3e} = {share:.3g} x limit")
    for c, m, n, cp, _names in tails:
        err, share = compare(cp, random_env(cp, gen), f"{c.name} at {m}x{n}")
        worst["cell"] = max(worst["cell"], share)
        log(f"[check] {c.name:30s} {m:>9d}x{n:<3d} CELL {layout_name(cp):4s} "
            f"{cp.variant:9s} max|kernel-plain| {err:.3e} = {share:.3g} x "
            f"limit")
    log(f"[check] sweep passed: {len(planned) + len(tails)} CPlans, limit "
        f"{KERNEL_ULPS} x eps32 x error scale; largest share of the limit "
        f"per kernel " + json.dumps(worst))
    for c, m, n, cp, _names in planned:
        faults = [f for f, names in (("partial", PLANTED),
                                     ("group", PLANTED_GROUP))
                  if c.name in names and m == M_SWEEP]
        for fault in faults:
            env = random_env(cp, gen)
            with planted_fault(group=fault == "group"):
                got = ops.execute(cp, env, kernels="cuda")
            err, share = measure(cp, env, got, f"planted {c.name}")
            log(f"[check] planted fault ({layout_name(cp)}, {fault}) "
                f"{c.name} at {m}x{n}: max|kernel-plain| {err:.3e} = "
                f"{share:.3g} x limit")
            if not share > 1.0:
                raise AssertionError(f"planted {fault} fault in {c.name} "
                                     f"passed the kernel check")
    cell_sweep_card_checks(planned, gen)

    for c, vals, cp, names in outer_planned:
        env = outer_case_env(c, vals, names)
        err, share = compare(cp, env, c.name)
        worst["outer"] = max(worst["outer"], share)
        log(f"[check] {c.name:30s} {c.shape[0]:>5d}x{c.shape[1]:<5d} "
            f"bs {c.bs:<3d} r {c.r:<2d} {env[cp.main.nid].nblocks:>3d} "
            f"blocks {cp.variant:9s} max|kernel-plain| {err:.3e} = "
            f"{share:.3g} x limit")
        for fold in (False, True):
            if c.name not in (PLANTED_FOLD if fold else PLANTED):
                continue
            with planted_fault(fold):
                got = ops.execute(cp, env, kernels="cuda")
            err, share = measure(cp, env, got, f"planted {c.name}")
            what = ("middle pieces dropped in the fold" if fold else
                    "middle blocks skipped" if c.variant == "right_mm"
                    else "one partial dropped")
            log(f"[check] planted fault ({what}) {c.name}: "
                f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
            if not share > 1.0:
                raise AssertionError(f"planted fault in {c.name} passed "
                                     f"the kernel check")
    log(f"[check] outer sweep passed: {len(outer_planned)} CPlans; largest "
        f"share of the limit {worst['outer']:.3g}")
    log(f"[check] sweep phase wall {time.perf_counter() - t0:.1f} s")

    # 4. the main path's CPlans at the main path's shapes -------------------
    t0 = time.perf_counter()
    big = {(m_main, N_MAIN): 0.3 * torch.randn((m_main, N_MAIN),
                                               generator=gen, device="cuda")}
    main_err = {k: 0.0 for k in KERNELS}
    envs = []
    for region, cp in main_cps:
        env = random_env(cp, gen, big)
        kname = kernel_name(cp)
        err, share = compare(cp, env, f"main-path {region} "
                                      f"{cp.ttype.name} {cp.variant}")
        main_err[kname] = max(main_err[kname], err)
        envs.append(env)
        log(f"[check] main path {region:22s} {kname:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} "
            f"binds {[tuple(b.shape) for b in cp.binds]} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        if kname == "cell":
            failed = cell_checks(region, cp, env)
            if failed:
                raise AssertionError("; ".join(failed))

    # 5. the main path -------------------------------------------------------
    log(f"[check] main-path CPlans phase wall {time.perf_counter() - t0:.1f} "
        f"s")
    t5 = time.perf_counter()
    X, y = l2svm_data(m_main)
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    w, objs = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    log(f"[main] l2svm.run X {m_main}x{N_MAIN} fp32, {len(objs)} "
        f"iterations, kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches {json.dumps(launches)}")
    log(f"[main] objective trace (kernels=cuda): {objs}")
    missing = [k for k in ("cell", "magg", "row") if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    if tuple(w.shape) != (N_MAIN, 1) or not bool(torch.isfinite(w).all()):
        raise AssertionError("main path: w is not a finite (n,1) vector")
    t0 = time.perf_counter()
    _w2, objs_plain = l2svm.run(X, y, max_iter=ITERS, kernels="never")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    _w3, objs_hand = l2svm.run(X, y, max_iter=ITERS, mode="hand")
    log(f"[main] kernels=never: {t_plain:.2f} s; trace {objs_plain}")
    log(f"[main] hand torch baseline trace {objs_hand}")
    rel, rel_hand = trace_rel(objs, objs_plain), trace_rel(objs_hand,
                                                           objs_plain)
    log(f"[main] max relative trace difference: kernels vs never "
        f"{rel:.3e}, hand vs never {rel_hand:.3e} (tolerance "
        f"{TRACE_RTOL:g})")
    if not (len(objs_plain) == ITERS and rel <= TRACE_RTOL
            and rel_hand <= TRACE_RTOL):
        raise AssertionError("main path: objective traces disagree")
    with planted_fault():
        _w4, objs_fault = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    rel_fault = trace_rel(objs_fault, objs_plain)
    log(f"[main] planted fault (one partial dropped in every reducing "
        f"kernel): trace {objs_fault}, max relative difference vs never "
        f"{rel_fault:.3e}")
    if not rel_fault > TRACE_RTOL:
        raise AssertionError("planted fault passed the trace check")
    profile_run(f"l2svm.run kernels=cuda, {ITERS} iterations",
                lambda: l2svm.run(X, y, max_iter=ITERS, kernels="cuda"))
    del X, y, w, _w2, _w3, _w4

    # 6. timing at the main path's shapes ----------------------------------
    per_kernel = dense_times(main_cps, envs)
    del big, envs
    torch.cuda.empty_cache()
    log(f"[main] l2svm run and timing phases wall "
        f"{time.perf_counter() - t5:.1f} s")

    # 7. ALS-CG on the Netflix-shaped BCSR -----------------------------------
    t0 = time.perf_counter()
    als = als_phase(counters, launches, main_err)
    per_kernel["outer"] = als
    log(f"[als] phase wall {time.perf_counter() - t0:.1f} s")

    # 8.-11. MLogReg, GLM, KMeans and the autoencoder ----------------------
    for path in paths:
        algo_phase(path, path_cps[path.name], counters, launches, main_err,
                   per_kernel)

    # 12. result lines -------------------------------------------------------
    rows = []
    for k, (src, replaces) in KERNELS.items():
        agg = per_kernel[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": main_err[k],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": max(agg["bound_by"], key=agg["bound_by"].get),
            "library_ms": None,
            "per": ("one call of each ALS-CG CPlan (sum over U update, V "
                    "update, loss)" if k == "outer" else
                    "one call of each main-path CPlan it runs, summed over "
                    "L2SVM, MLogReg, GLM, KMeans and the autoencoder"),
            "parts": agg["parts"]})
    log(json.dumps({"kernels": rows}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def als_phase(counters, launches, main_err) -> dict:
    """ALS-CG at the main path's shape: its CPlans against plain, the run
    with ``kernels="cuda"`` (launch counts into ``launches``), its trace
    against ``kernels="never"`` and a planted fault, the hand baseline at
    the reduced shape, a profile, and per-CPlan times; returns the Outer
    kernel's timing record."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.kernels import outerprod
    from repro_torch.kernels.blocksparse import PIECE_BLOCKS
    t0 = time.perf_counter()
    X = netflix_like(ALS_SHAPE, seed=0)
    torch.cuda.synchronize()
    m, n = X.shape
    log(f"[als] X {ALS_SHAPE[0]}x{ALS_SHAPE[1]} padded to {m}x{n}, bs "
        f"{X.bs}: {X.nblocks} blocks (block density "
        f"{X.block_sparsity:.4f}), {X.data.numel() * 4 / 1e9:.2f} GB; built "
        f"on the card in {time.perf_counter() - t0:.1f} s")

    # the main path
    run = lambda **kw: als_cg.run(X, rank=ALS_RANK, max_iter=ALS_ITERS,
                                  max_inner=ALS_INNER, **kw)
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    U, V, losses = run(kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches["outer"] = outerprod.launches
    log(f"[als] als_cg.run rank {ALS_RANK}, {ALS_ITERS} x {ALS_INNER} "
        f"iterations, kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches "
        + json.dumps({k: mod.launches for k, mod in counters.items()}))
    log(f"[als] loss trace (kernels=cuda): {losses}")
    if outerprod.launches == 0:
        raise AssertionError("ALS main path never launched the outer kernel")
    if tuple(U.shape) != (m, ALS_RANK) or tuple(V.shape) != (n, ALS_RANK) \
            or not bool(torch.isfinite(U).all() & torch.isfinite(V).all()):
        raise AssertionError("ALS main path: U, V not finite of their shape")
    del U, V
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _u, _v, losses_plain = run(kernels="never")
    torch.cuda.synchronize()
    log(f"[als] kernels=never: {time.perf_counter() - t0:.2f} s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(X and X^T resident); trace {losses_plain}")
    del _u, _v
    with planted_fault():
        _u, _v, losses_fault = run(kernels="cuda")
    del _u, _v
    rel = trace_rel(losses, losses_plain)
    rel_fault = trace_rel(losses_fault, losses_plain)
    log(f"[als] planted fault (right_mm skips the middle block of every "
        f"block row, full_agg drops a partial): trace {losses_fault}")
    log(f"[als] max relative trace difference vs never: sound {rel:.3e}, "
        f"planted {rel_fault:.3e} (tolerance {TRACE_RTOL:g})")
    # checked at the end of the phase, so one run reports every reading
    failed = []
    if not (len(losses_plain) == ALS_ITERS and rel <= TRACE_RTOL):
        failed.append("ALS main path: loss traces disagree")
    if not rel_fault > TRACE_RTOL:
        failed.append("planted fault passed the ALS trace check")
    profile_run(f"als_cg.run kernels=cuda, rank {ALS_RANK}, {ALS_ITERS} x "
                f"{ALS_INNER} iterations", lambda: run(kernels="cuda"))

    # the dense-mask hand baseline, at the reduced shape
    Xh = netflix_like(ALS_HAND_SHAPE, seed=1)
    kw = dict(rank=ALS_RANK, max_iter=ALS_ITERS, max_inner=ALS_INNER)
    _u, _v, l_gen = als_cg.run(Xh, kernels="cuda", **kw)
    _u, _v, l_hand = als_cg.run(Xh, mode="hand", **kw)
    rel_hand = trace_rel(l_gen, l_hand)
    log(f"[als] reduced {Xh.shape[0]}x{Xh.shape[1]} ({Xh.nblocks} blocks): "
        f"gen (kernels=cuda) {l_gen}; hand {l_hand}; max relative "
        f"difference {rel_hand:.3e} (tolerance {ALS_HAND_RTOL:g})")
    if not rel_hand <= ALS_HAND_RTOL:
        failed.append("ALS hand baseline disagrees with gen")
    del Xh, _u, _v

    # the ALS CPlans at the main path's shapes against plain
    XT = X.T                # the runs above built and dropped their own
    log(f"[als] Outer grid: {X.pieces.table.shape[0]} pieces over X's "
        f"{m // X.bs} block rows, {XT.pieces.table.shape[0]} over X^T's "
        f"{n // X.bs} (at most {PIECE_BLOCKS} blocks each)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cps = als_cplans(X, XT)
    envs = []
    for label, cp in cps:
        env = als_env(cp, XT if label.endswith("V-update") else X, gen)
        err, share = compare(cp, env, f"main-path {label}")
        main_err["outer"] = max(main_err["outer"], err)
        envs.append(env)
        log(f"[check] main path {label:22s} outer {cp.variant:9s} binds "
            f"{[tuple(b.shape) for b in cp.binds]} max|kernel-plain| "
            f"{err:.3e} = {share:.3g} x limit")
        if label.endswith("V-update"):
            with planted_fault(fold=True):
                got = outerprod.outer(cp, env)
            err, share = measure(cp, env, got, f"planted fold {label}")
            del got
            log(f"[check] planted fault (middle pieces dropped in the "
                f"fold) main path {label}: max|kernel-plain| {err:.3e} = "
                f"{share:.3g} x limit")
            if not share > 1.0:
                failed.append(f"planted fold fault in {label} passed the "
                              f"kernel check")

    # timing at the main path's shapes
    rec = outer_times(cps, envs)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def times_only() -> None:
    """``--times``: the readings of speed only, to compare two trees of the
    port on one card: the profiles of every main path and the times of
    their CPlans, with no checks and no result line.  Copied into an older
    checkout, the script reads that checkout's package the same way."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.algos import als_cg, l2svm
    from repro_torch.kernels import build, cuda_src
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    main_cps = main_path_cplans(M_MAIN, N_MAIN)
    path_cps = [(path, path_cplans(path)) for path in algo_paths(M_MAIN)]
    shape = padded(ALS_SHAPE)
    als_meta = als_cplans(meta_bcsr(shape), meta_bcsr(shape[::-1]))
    srcs = [cuda_src.source_for(cp) for _r, cp in main_cps] + \
        [cuda_src.source_for(cp) for _p, cps in path_cps
         for _r, cp in cps] + \
        [cuda_src.source_for(cp, ALS_BS) for _l, cp in als_meta]
    build.build_all({s.key: s for s in srcs}.values())

    X, y = l2svm_data(M_MAIN)
    l2svm.run(X, y, max_iter=ITERS, kernels="cuda")       # plans cached
    profile_run(f"l2svm.run kernels=cuda, {ITERS} iterations",
                lambda: l2svm.run(X, y, max_iter=ITERS, kernels="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    envs = [random_env(cp, gen, {(M_MAIN, N_MAIN): X}) for _r, cp in main_cps]
    dense_times(main_cps, envs)
    del X, y, envs
    torch.cuda.empty_cache()

    Xs = netflix_like(ALS_SHAPE, seed=0)
    run = lambda: als_cg.run(Xs, rank=ALS_RANK, max_iter=ALS_ITERS,
                             max_inner=ALS_INNER, kernels="cuda")
    run()                                                   # plans cached
    profile_run(f"als_cg.run kernels=cuda, rank {ALS_RANK}, {ALS_ITERS} x "
                f"{ALS_INNER} iterations", run)
    XT = Xs.T
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cps = als_cplans(Xs, XT)
    outer_times(cps, [als_env(cp, XT if label.endswith("V-update") else Xs,
                              gen) for label, cp in cps])
    del Xs, XT
    torch.cuda.empty_cache()

    for path, cps in path_cps:
        ops = path.data()
        path.run(ops, kernels="cuda")                       # plans cached
        profile_run(f"{path.name} kernels=cuda, {path.depth}",
                    lambda: path.run(ops, kernels="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(2468)
        shared = {tuple(ops[0].shape): ops[0]}
        dense_times(cps, [random_env(cp, gen, shared) for _l, cp in cps])
        del ops, shared
        torch.cuda.empty_cache()
    log(card_line())


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--times"]):
        print("usage: python3 chip_smoke.py [--times]", file=sys.stderr)
        return 2
    try:
        times_only() if args else run()
    except Exception:                 # noqa: BLE001 - report, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
