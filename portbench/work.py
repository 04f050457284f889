"""The yardstick's arithmetic: the card's peaks, the least time of a kernel
launch, and each script's work a fit.

``bound_ms``, ``program_flops`` and ``outer_bound_ms`` are frozen copies of
``chip_smoke.py`` at commit f8ea0f9 (its ``bound_ms`` / ``program_flops`` /
``outer_bound_ms``), reading only what the CPlan and its operands say; the
program may change, these may not.  The ``*_fit_work`` functions count a
fit's work from the configuration's shapes and the mix's iteration counts,
as the script states its products: never from the plan or the kernels, so
they read the same work whatever implements it.
"""

from __future__ import annotations

#: H100 SXM datasheet: HBM3 bandwidth (B/s) and the fp32 rate outside the
#: tensor cores (FLOP/s); the generated kernels use IEEE fp32 FMAs
HBM_BW = 3.35e12
FP32_PEAK = 67e12


def least_ms(nbytes: float, flops: float) -> float:
    """The least time of work that moves ``nbytes`` over HBM and does
    ``flops`` fp32 operations: the larger of the two bounds, in ms."""
    return max(nbytes / HBM_BW, flops / FP32_PEAK) * 1e3


# --------------------------------------------------------------------------
# a kernel launch (frozen copies of chip_smoke.py at f8ea0f9)
# --------------------------------------------------------------------------

def bound_ms(cplan, env, out) -> tuple[float, str]:
    """Least time for the same work: each distinct input read once and the
    output written once over HBM bandwidth, or the program's fp32 flops
    over the fp32 peak — the larger, and which one it is."""
    main = env[cplan.main.nid]
    if hasattr(main, "nblocks"):                 # a BCSR main
        return outer_bound_ms(cplan, env, out)
    seen, nbytes = set(), out.numel() * 4
    for t in env.values():
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    t_bytes = nbytes / HBM_BW * 1e3
    t_flops = program_flops(cplan, out) / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def program_flops(cplan, out) -> int:
    """fp32 operations of one call of a dense CPlan: a cell per program
    value, 2 x inner per matmul cell, the col_t_agg close."""
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
    return flops


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


# --------------------------------------------------------------------------
# a fit: (bytes, flops) of its products over the main operand.  A step is
# one outer iteration; it reads the main operand once (the bytes), and its
# products over it are counted as the script writes them (the flops).
# --------------------------------------------------------------------------

def l2svm_fit_work(m: int, n: int, iters: int) -> tuple[int, int]:
    """L2SVM (``l2-svm.dml``): the first gradient (X w forward, Xᵀ(out⊙y)
    backward), then per iteration X s, the hinge's X w, the objective's
    X w and its gradient's Xᵀ(out⊙y): 2mn flops each."""
    return iters * m * n * 4, 2 * m * n * (2 + 4 * iters)


def mlogreg_fit_work(m: int, n: int, k: int, outer: int,
                     inner: int) -> tuple[int, int]:
    """MLogReg (``MultiLogReg.dml``), per outer iteration: the
    probabilities' X B, the objective's X B and its gradient's Xᵀ(P − Y),
    then per CG step the Hessian-vector product's X v and its Xᵀ close:
    2mnk flops each."""
    return outer * m * n * 4, 2 * m * n * k * outer * (3 + 2 * inner)


def kmeans_fit_work(m: int, n: int, k: int, iters: int) -> tuple[int, int]:
    """K-Means (``Kmeans.dml``): the row norms Σ X² once (2mn), then per
    iteration X Cᵀ and Aᵀ X (2mnk each)."""
    return iters * m * n * 4, 2 * m * n + 4 * m * n * k * iters


def als_fit_work(stored: int, nblocks: int, mb: int, rank: int, outer: int,
                 inner: int) -> tuple[int, int]:
    """ALS-CG (``ALS-CG.dml``) over ``stored`` cells in ``nblocks`` stored
    blocks of ``mb`` block rows, counted over stored blocks only.  Per outer
    iteration and side (U over X, V over Xᵀ): the gradient's
    ((X≠0)⊙(UVᵀ))V (UVᵀ 2r and the close 2r flops a stored cell) and X V
    (2r), then ``inner`` Hessian products ((X≠0)⊙(sVᵀ))V (4r); and the
    loss's UVᵀ (2r).  Bytes: X's stored blocks, their block indices and
    block-row pointer, read once a step."""
    per_outer = stored * rank * (2 * (4 * (1 + inner) + 2) + 2)
    nbytes = (stored + 2 * nblocks + mb + 1) * 4
    return outer * nbytes, outer * per_outer
