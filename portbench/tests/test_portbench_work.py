"""The yardstick's counts held to hand counts at small shapes, so that no
share can read over 100 % from a miscount."""

import pytest
import torch

from portbench import work


def meta(*s):
    return torch.empty(s, device="meta")


def test_least_ms_takes_the_larger_bound():
    assert work.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert work.least_ms(0, 67e9) == pytest.approx(1.0)
    assert work.least_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)


def test_hinge_cplan_counts_by_hand():
    from repro_torch.algos import l2svm
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    m, n = 1000, 10
    with FusionContext():
        planned = l2svm._hinge.trace(meta(m, n), meta(n, 1), meta(m, 1)).plan()
    (cp,) = compile_plan(planned.eplan).cplans()
    out = torch.empty(m, 1)
    # X w: 2 m n; y * (.), 1 - (.), relu: a cell each
    assert work.program_flops(cp, out) == 2 * m * n + 3 * m
    env = {b.nid: torch.empty(tuple(b.shape)) for b in cp.binds}
    ms, kind = work.bound_ms(cp, env, out)
    assert kind == "bytes"
    # X, y, w read once, out written once
    assert ms == pytest.approx(4 * (m * n + m + n + m) / work.HBM_BW * 1e3)


def test_a_shared_operand_is_read_once():
    from repro_torch.algos import l2svm
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    m = 1000
    with FusionContext():
        planned = l2svm._search_terms.trace(meta(m, 1), meta(m, 1)).plan()
    (cp,) = compile_plan(planned.eplan).cplans()
    col = torch.empty(m, 1)
    env = {b.nid: col for b in cp.binds}           # one tensor, every bind
    out = torch.empty(1, 2)
    ms, _kind = work.bound_ms(cp, env, out)
    assert ms == pytest.approx(4 * (m + 2) / work.HBM_BW * 1e3)


def test_outer_bound_counts_stored_blocks_only():
    from repro_torch.algos import als_cg
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    from repro_torch.kernels.blocksparse import BCSR
    bs, r, mb, nbc = 4, 3, 64, 64
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(mb, nbc, generator=g) < 0.1
    rows, cols = torch.nonzero(mask, as_tuple=True)
    nb = rows.numel()
    X = BCSR(torch.ones(nb, bs, bs), rows.int(), cols.int(),
             (mb * bs, nbc * bs), bs)
    U, V = torch.ones(mb * bs, r), torch.ones(nbc * bs, r)
    with FusionContext(device="cpu"):
        planned = als_cg._wsq_mm.trace(X, U, V).plan()
    (cp,) = compile_plan(planned.eplan).cplans()
    assert cp.variant == "right_mm"
    env = {b.nid: {"main": X, "factor_u": U, "factor_v": V}[b.kind]
           for b in cp.binds}
    out = torch.empty(mb * bs, r)
    ms, kind = work.outer_bound_ms(cp, env, out)
    ops = sum(op != "matmul" for (_n, op, *_r) in cp.prog)
    # per stored block: U_b V_bᵀ 2 bs² r, the close 2 bs² r, the chain
    flops = nb * bs * bs * (2 * r + 2 * r + ops)
    nbytes = (nb * bs * bs + 2 * nb + mb + 1 + U.numel() + V.numel()
              + out.numel()) * 4
    assert ms == pytest.approx(max(nbytes / work.HBM_BW,
                                   flops / work.FP32_PEAK) * 1e3)


def test_fit_work_by_hand():
    m, n, k = 100, 10, 5
    # L2SVM, 3 iterations: 2 products before the loop, 4 in each
    assert work.l2svm_fit_work(m, n, 3) == (3 * m * n * 4,
                                            2 * m * n * (2 + 12))
    # MLogReg, 2 outer x 3 CG: 3 + 2 x 3 products an outer iteration
    assert work.mlogreg_fit_work(m, n, k, 2, 3) == (2 * m * n * 4,
                                                     2 * m * n * k * 2 * 9)
    # K-Means, 4 iterations: Σ X² once, X Cᵀ and Aᵀ X each iteration
    assert work.kmeans_fit_work(m, n, k, 4) == (4 * m * n * 4,
                                                2 * m * n + 2 * 4 * 2 * m * n
                                                * k)
    # ALS, 2 outer x 5 CG over S stored cells in nb blocks of mb block rows:
    # per side the gradient's 4r + 2r and 5 Hessian products' 4r, the
    # loss's 2r
    S, nb, mb, r = 1600, 100, 10, 20
    per_side = (4 + 2 + 5 * 4) * r
    assert work.als_fit_work(S, nb, mb, r, 2, 5) == (
        2 * (S + 2 * nb + mb + 1) * 4, 2 * S * (2 * per_side + 2 * r))
