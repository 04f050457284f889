"""The Outer template and the BCSR routes of the port's dispatch, on the
CPU, against the JAX reference on the same seeded numpy inputs.

* Outer ``right_mm`` / ``full_agg`` CPlans (``ops.execute`` with
  ``kernels="cuda"`` on CPU tensors, which takes ``outer_plain``) against
  the reference's ``outer_pallas(..., interpret=True)`` and its jnp block
  loop ``_execute_bcsr``: the grid {(2,2),(4,3)} × block density {0.0,
  0.3, 0.7, 1.0} of ``tests/test_kernels.py`` at bs 128, bs-16 cases, and
  every case of the Outer kernel sweep (sides, empty block rows, the ALS
  loss chain).
* Outer ``left_mm`` and ``no_agg``, which the reference (and the port)
  run through the block loop under either kernel policy.
* Sparse-safe Cell / Row / MAgg chains over a BCSR main and the sparse
  basic operators, through the staged API of both packages.

Tolerance: 1e-5 relative to max|reference|.  A ``full_agg`` of signed
terms can cancel far below the size of its terms (the reference's own two
block paths differ by 2.3e-5 of the sum on one grid case), so a sum is
also accepted within 8 fp32 eps of its first-order error scale (the
``chip_smoke.py`` bound ``tests/test_torch_kernels.py`` checks: each fp32
version lies within 4 eps of it from the exact value).  Also checked: the error scale
``chip_smoke.py`` holds the kernel to bounds the plain version's rounding
on every sweep case, and the Outer kernel's source is generated per CPlan
and block size.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FusionContext as RefContext, fused as ref_fused
from repro.kernels import ops as rops
from repro.kernels.blocksparse import BCSR as RBCSR
from repro.kernels.outerprod import outer_pallas
from repro_torch.core import FusionContext, fused
from repro_torch.kernels import build, cuda_src, ops, outerprod, sweep
from repro_torch.kernels.blocksparse import BCSR

from torch_harness import reference_cplan
from torch_regions import chip_smoke

torch.set_num_threads(1)
TOL = 1e-5


def _grid_cases():
    out = []
    for variant in ("right_mm", "full_agg"):
        for grid in ((2, 2), (4, 3)):
            for d in (0.0, 0.3, 0.7, 1.0):
                out.append(sweep.OuterCase(
                    f"{variant}_{grid[0]}x{grid[1]}_d{d}", variant, 128,
                    grid, d, 8))
        out.append(sweep.OuterCase(f"{variant}_bs16", variant, 16, (9, 8),
                                   0.4, 6))
    return out


def _envs(case, vals, names_r, names_t):
    env_r = {nid: (RBCSR.from_dense(vals[n], bs=case.bs) if n == "X"
                   else jnp.asarray(vals[n])) for nid, n in names_r.items()}
    env_t = {nid: (BCSR.from_dense(vals[n], bs=case.bs) if n == "X"
                   else torch.tensor(vals[n])) for nid, n in names_t.items()}
    return env_r, env_t


def _check(got, want, rounding=None):
    """|got - want| <= 1e-5 max|want|, or for a sum (``rounding``: its
    first-order error scale) <= 8 eps x that scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    limit = TOL * max(float(np.abs(want).max()), 1e-30)
    if rounding is not None:
        eps = float(np.finfo(np.float32).eps)
        limit = max(limit, 8 * eps * float(rounding.max()))
    assert float(np.abs(got - want).max()) <= limit


def _plan_both(case, vals):
    sp = {"X": BCSR.from_dense(vals["X"], case.bs).block_sparsity}
    cp_r, names_r = reference_cplan(case, *case.shape, sparsity=sp)
    cp_t, names_t = sweep.fused_cplan(case, *case.shape, sparsity=sp)
    assert (cp_t.ttype.name, cp_t.variant) == (cp_r.ttype.name,
                                               cp_r.variant)
    assert cp_t.main.exploit and cp_r.main.exploit
    return cp_r, names_r, cp_t, names_t


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name) for c in
                                  _grid_cases() + sweep.outer_cases()])
def test_plain_matches_pallas_interpret_and_block_loop(case):
    vals = sweep.outer_values(case, seed=len(case.name))
    cp_r, names_r, cp_t, names_t = _plan_both(case, vals)
    env_r, env_t = _envs(case, vals, names_r, names_t)
    before = outerprod.launches
    got = ops.execute(cp_t, env_t, kernels="cuda").numpy()
    assert outerprod.launches == before            # CPU: the plain version
    rounding = (chip_smoke().error_scale(cp_t, env_t).numpy()
                if case.variant == "full_agg" else None)
    _check(got, outer_pallas(cp_r, env_r, interpret=True), rounding)
    _check(got, rops._execute_bcsr(cp_r, env_r), rounding)
    _check(outerprod.outer_plain(cp_t, env_t).numpy(), got)


@dataclass(frozen=True)
class _Outer:
    """An Outer CPlan the sweep does not cover (``left_mm``, ``no_agg``)."""
    name: str
    variant: str
    bs: int = 128
    grid: tuple = (3, 2)
    density: float = 0.5
    r: int = 4
    empty_rows: tuple = ()
    template: str = "outer"
    want: str = "OUTER"

    @property
    def shape(self):
        return self.grid[0] * self.bs, self.grid[1] * self.bs

    def shapes(self, m, n):
        return {"X": (m, n), "U": (m, self.r), "V": (n, self.r),
                "W": (m, self.r)}

    def expr(self, ir, X, U, V, W):
        c = ir.neq0(X) * (U @ V.T)
        return W.T @ c if self.variant == "left_mm" else c * 2.0


@pytest.mark.parametrize("variant", ["left_mm", "no_agg"])
@pytest.mark.parametrize("kernels", ["cuda", "never"])
def test_outer_left_mm_and_no_agg_run_the_block_loop(variant, kernels):
    case = _Outer(variant, variant)
    vals = sweep.outer_values(case, seed=4)
    cp_r, names_r, cp_t, names_t = _plan_both(case, vals)
    assert cp_t.variant == variant
    env_r, env_t = _envs(case, vals, names_r, names_t)
    want = rops.execute(cp_r, env_r, pallas="interpret")
    before = outerprod.launches
    got = ops.execute(cp_t, env_t, kernels=kernels)
    assert outerprod.launches == before
    if variant == "no_agg":
        assert isinstance(got, BCSR) and isinstance(want, RBCSR)
        np.testing.assert_array_equal(got.rows.numpy(),
                                      np.asarray(want.rows))
        got, want = got.todense(), want.todense()
    _check(got.numpy(), want)


def _ratings(seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((3, 2)) < 0.5
    mask.flat[0] = True
    x = rng.normal(size=(384, 256)).astype(np.float32)
    return x * np.kron(mask, np.ones((128, 128), np.float32))


#: sparse-safe chains over a BCSR main (Cell / Row / MAgg exploiting its
#: sparsity) and unfused sparse basic ops, with their dense operand shapes
SPARSE_REGIONS = {
    "cell_full_sum": (lambda X, Y: (X * Y).sum(), {"Y": (384, 256)}),
    "cell_row_sums": (lambda X, Y: (X ** 2).rowsums(), {"Y": (1, 1)}),
    "cell_col_sums": (lambda X, Y: (X * Y).colsums(), {"Y": (384, 1)}),
    "cell_no_agg": (lambda X, Y: X * Y, {"Y": (1, 256)}),
    "bcsr_matmul": (lambda X, Y: X @ Y, {"Y": (256, 5)}),
    "bcsr_matmul_ta": (lambda X, Y: X.T @ Y, {"Y": (384, 3)}),
}


@pytest.mark.parametrize("name", sorted(SPARSE_REGIONS))
def test_sparse_regions_through_the_staged_api(name):
    fn, shapes = SPARSE_REGIONS[name]
    dense = _ratings()
    y = np.random.default_rng(9).normal(size=shapes["Y"]).astype(np.float32)
    with RefContext(mode="gen"):
        want = ref_fused(fn)(RBCSR.from_dense(dense, 128), jnp.asarray(y))
    with FusionContext(device="cpu"):
        f = fused(fn)
        got = f(BCSR.from_dense(dense, 128), torch.tensor(y))
        rep = f.trace(BCSR.from_dense(dense, 128), y).plan().explain()
    assert rep["inputs"]["X"]["format"] == "bcsr"
    assert rep["inputs"]["X"]["sparsity"] == round(
        BCSR.from_dense(dense, 128).block_sparsity, 4)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert isinstance(a, BCSR) == isinstance(b, RBCSR)
        a = a.todense() if isinstance(a, BCSR) else a
        b = b.todense() if isinstance(b, RBCSR) else b
        _check(a.numpy(), b)


def test_multi_aggregate_over_bcsr_returns_every_root():
    """A two-root MAgg over a BCSR main: the port returns both sums, as the
    reference's dense path does.  The reference's sparse path returns the
    first sum for both roots (its block loop evaluates only the first root
    and JAX clamps the out-of-range index; ROADMAP queue C), pinned here
    so that a fix there shows."""
    fn = lambda X, Y: ((X * Y).sum(), (X ** 2).sum())
    dense = _ratings()
    y = np.random.default_rng(9).normal(size=(384, 256)).astype(np.float32)
    with RefContext(mode="gen"):
        want = ref_fused(fn)(jnp.asarray(dense), jnp.asarray(y))
        ref_sparse = ref_fused(fn)(RBCSR.from_dense(dense, 128),
                                   jnp.asarray(y))
    with FusionContext(device="cpu"):
        got = fused(fn)(BCSR.from_dense(dense, 128), torch.tensor(y))
    for a, b in zip(got, want):
        _check(a.numpy(), b)
    assert float(got[1].reshape(())) != pytest.approx(
        float(got[0].reshape(())))
    assert np.array_equal(np.asarray(ref_sparse[1]), np.asarray(ref_sparse[0]))


def test_bcsr_basic_ops_match_reference():
    dense = _ratings(5)
    rng = np.random.default_rng(2)
    b = rng.normal(size=(256, 7)).astype(np.float32)
    d = rng.normal(size=(384, 256)).astype(np.float32)
    xr, xt = RBCSR.from_dense(dense, 128), BCSR.from_dense(dense, 128)
    _check(ops.bcsr_matmul(xt, torch.tensor(b)).numpy(),
           rops.bcsr_matmul(xr, jnp.asarray(b)))
    _check(ops.bcsr_matmul(xt.T, torch.tensor(d[:, :4].copy())).numpy(),
           rops.bcsr_matmul(xr.T, jnp.asarray(d[:, :4])))
    got, want = ops.bcsr_mul_dense(xt, torch.tensor(d)), \
        rops.bcsr_mul_dense(xr, jnp.asarray(d))
    _check(got.todense().numpy(), want.todense())
    got, want = ops.bcsr_cellwise("abs", xt), rops.bcsr_cellwise("abs", xr)
    _check(got.data.numpy(), want.data)


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in sweep.outer_cases()])
def test_error_scale_bounds_the_outer_rounding(case):
    """``chip_smoke.py``'s limit over a BCSR main: the per-block bound has
    the output's shape, is at least the result's magnitude, equals itself
    chunked, and bounds the fp32 plain version's distance from fp64."""
    vals = sweep.outer_values(case, seed=3)
    cp, names = sweep.fused_cplan(
        case, *case.shape,
        sparsity={"X": BCSR.from_dense(vals["X"], case.bs).block_sparsity})
    env = {nid: (BCSR.from_dense(vals[n], case.bs) if n == "X"
                 else torch.tensor(vals[n])) for nid, n in names.items()}
    smoke = chip_smoke()
    scale = smoke.error_scale(cp, env)
    plain = outerprod.outer_plain(cp, env)
    env64 = {k: (BCSR(v.data.double(), v.rows, v.cols, v.shape, v.bs)
                 if isinstance(v, BCSR) else v.double())
             for k, v in env.items()}
    exact = outerprod.outer_plain(cp, env64)
    assert tuple(scale.shape) == tuple(plain.shape)
    assert bool((scale >= plain.abs() * (1 - 1e-6)).all())
    torch.testing.assert_close(smoke.bcsr_error_scale(cp, env, chunk=5),
                               scale, rtol=1e-5, atol=0.0)
    eps = torch.finfo(torch.float32).eps
    assert bool(((plain.double() - exact).abs()
                 <= 4 * eps * scale.double()).all())


def test_outer_source_is_per_cplan_and_block_size():
    case = next(c for c in sweep.outer_cases()
                if c.name == "outer/right_mm_side_col")
    cp, _ = sweep.fused_cplan(case, *case.shape, sparsity={"X": 0.5})
    src = cuda_src.source_for(cp, bs=128)
    assert src.template == "outer" and src.elems == 0
    assert '#include "outer.cuh"' in src.text
    assert "repro_launch_outer" in src.text and "BS = 128" in src.text
    assert "K = 20" in src.text and "R = 20" in src.text
    assert cuda_src.source_for(cp, bs=64).key != src.key
    assert cuda_src.source_for(cp, bs=128) is src
    with pytest.raises(NotImplementedError, match="block size"):
        cuda_src.outer_source(cp, 24)
    header = (build.CSRC / "outer.cuh").read_text()
    assert "#ifdef RK_PLANTED_FAULT" in header
    assert "#ifdef RK_PLANTED_FOLD" in header
    planted = chip_smoke().planted(src)
    assert planted.text == chip_smoke().PLANT + src.text
    fold = chip_smoke().planted(src, fold=True)
    assert fold.text == chip_smoke().PLANT_FOLD + src.text
    full = next(c for c in sweep.outer_cases()
                if c.name == "outer/full_agg_loss")
    cpf, _ = sweep.fused_cplan(full, *full.shape, sparsity={"X": 0.7})
    assert cuda_src.source_for(cpf, bs=128).elems == 1


def test_outer_shared_memory_accounting_fits_and_refuses_above_a_cta():
    """The layout ``outer_source`` writes into ``Prog`` (``outer.cuh``
    checks its sum with a static_assert): every sweep case and the ALS
    CPlans fit a CTA's 227 KB, the ALS ones at bs 128, rank 20 in the
    ~113 KB that lets two CTAs share an SM, every stripe takes whole
    float4 groups; a rank whose ring cannot fit is refused."""
    smoke = chip_smoke()
    plans = []
    for case in sweep.outer_cases():
        cp, _ = sweep.fused_cplan(case, *case.shape, sparsity={"X": 0.5})
        plans.append((case.name, cp, case.bs))
    shape = smoke.padded(smoke.ALS_SHAPE)
    als = smoke.als_cplans(smoke.meta_bcsr(shape),
                           smoke.meta_bcsr(shape[::-1]))
    plans += [(label, cp, smoke.ALS_BS) for label, cp in als]
    for name, cp, bs in plans:
        src = cuda_src.source_for(cp, bs=bs)
        kinds = [b.kind for b in cp.binds]
        r = cp.binds[kinds.index("factor_u")].shape[1]
        k = cuda_src.root_shape(cp, cp.close_nid)[0 if cp.close_tb else 1] \
            if cp.variant == "right_mm" else 0
        close_is_v = (cp.variant == "right_mm" and not cp.close_tb and
                      cp.close_nid == cp.binds[kinds.index("factor_v")].nid)
        lay = cuda_src.outer_layout(bs, r, k, cp.variant, close_is_v)
        assert (f"THREADS = {lay.threads}, RPT = {lay.rpt}, SC = {lay.sc}, "
                f"STAGES = {lay.stages}, SMEM = {lay.smem};") in src.text
        assert 0 < lay.smem <= 227 * 1024 and lay.stages >= 3, name
        rb = bs // lay.rpt
        assert lay.threads == rb * lay.stripes <= 256
        assert bs % lay.sc == 0 and lay.sc % (4 * lay.stripes) == 0
        if not name.startswith("outer/"):
            assert bs == 128 and r == 20 and lay.smem == 62_976
            assert lay.smem <= 113 * 1024          # two CTAs per SM
    case = sweep.OuterCase("wide", "right_mm", 128, (4, 3), 0.5, 300)
    cp, _ = sweep.fused_cplan(case, *case.shape, sparsity={"X": 0.5})
    with pytest.raises(NotImplementedError, match="shared memory"):
        cuda_src.outer_source(cp, 128)


def test_outer_raises_where_the_reference_refuses():
    """A side of a shape the reference's Outer kernel refuses raises in
    both versions; a dense Outer main has no kernel (the torch oracle runs
    it, as the reference falls through to XLA); a BCSR that is neither on
    the CPU nor on a card is refused, not sent to the plain version."""
    case = next(c for c in sweep.outer_cases()
                if c.name == "outer/right_mm_side_scalar")
    vals = sweep.outer_values(case)
    cp, names = sweep.fused_cplan(case, *case.shape, sparsity={"X": 0.5})
    env = {nid: (BCSR.from_dense(vals[n], case.bs) if n == "X"
                 else torch.tensor(vals[n])) for nid, n in names.items()}
    bad = dict(env)
    side = next(b.nid for b in cp.binds if b.kind == "scalar")
    bad[side] = torch.ones((2, 3))
    with pytest.raises(NotImplementedError, match="side"):
        outerprod.outer(cp, bad)
    with pytest.raises(NotImplementedError, match="side"):
        outerprod.outer_plain(cp, bad)
    with pytest.raises(NotImplementedError, match="no CUDA template"):
        cuda_src.source_for(cp)
    meta = {k: (v.to("meta") if isinstance(v, BCSR) else v.to("meta"))
            for k, v in env.items()}
    with pytest.raises(ValueError, match="CUDA"):
        outerprod.outer(cp, meta)
