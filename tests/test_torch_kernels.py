"""Cell, MAgg and Row in the port.

On the CPU the kernel wrappers take their plain versions; those are held
against the reference's Pallas kernels run in interpret mode, as the
reference's own kernel tests run them, on every case of the kernel sweep
(``repro_torch.kernels.sweep``: every variant, sum/min/max/mean, narrow
matmuls, in-program rowsums/rowmaxs, col_t_agg) at the ragged 33×7 shape
and at an (m,1) main.  Tolerance 1e-5.  The CUDA side is tested for what
holds without a card: sources are generated per CPlan and independent of
m, modules import without nvcc, and a request for the card raises.  The
kernels themselves are held against their plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.cellwise import cell_pallas
from repro.kernels.multiagg import multiagg_pallas
from repro.kernels.rowwise import row_pallas
from repro_torch.algos import l2svm
from repro_torch.core import FusionContext
from repro_torch.core.codegen import compile_plan
from repro_torch.kernels import build, cuda_src, ops, sweep

from torch_harness import reference_cplan
from torch_regions import chip_smoke

torch.set_num_threads(1)
TOL = 1e-5
PALLAS = {"cell": cell_pallas, "magg": multiagg_pallas, "row": row_pallas}
#: sweep cases the reference's Pallas kernel cannot run (ROADMAP queue C):
#: a Cell root column-sliced narrower than its main
PALLAS_CANNOT = {"cell/idx_where"}


def _runs():
    for c in sweep.cases():
        for shape in ((33, 7), (33, 1)):
            if shape[1] >= c.min_n and c.name not in PALLAS_CANNOT:
                yield pytest.param(c, shape, id=f"{c.name}-{shape[0]}x"
                                                f"{shape[1]}")


def _values(case, shape, seed=11):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in case.shapes(*shape).items()}


@pytest.mark.parametrize("case,shape", _runs())
def test_plain_matches_pallas_interpret(case, shape):
    cp_r, names_r = reference_cplan(case, *shape)
    cp_t, names_t = sweep.fused_cplan(case, *shape)
    assert cuda_src.source_for(cp_t).template == case.template
    vals = _values(case, shape)
    want = PALLAS[case.template](
        cp_r, {nid: jnp.asarray(vals[n]) for nid, n in names_r.items()},
        interpret=True)
    # CPU tensors: the wrapper the dispatcher picks takes the plain version
    got = ops.execute(cp_t, {nid: torch.tensor(vals[n])
                             for nid, n in names_t.items()}, kernels="cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_cell_column_slice_runs_where_the_pallas_kernel_cannot():
    """Queue C: ``cell_pallas`` tiles the main (33×7) but the sliced root
    is 33×6, so the reference kernel refuses the CPlan; the port's Cell
    kernel walks the root's domain, and its plain version matches the
    reference's XLA oracle."""
    from repro.kernels import ref as jref
    case = next(c for c in sweep.cases() if c.name == "cell/idx_where")
    cp_r, names_r = reference_cplan(case, 33, 7)
    cp_t, names_t = sweep.fused_cplan(case, 33, 7)
    vals = _values(case, (33, 7))
    env_r = {nid: jnp.asarray(vals[n]) for nid, n in names_r.items()}
    with pytest.raises(ValueError, match="shape"):
        cell_pallas(cp_r, env_r, interpret=True)
    src = cuda_src.source_for(cp_t)
    assert src.template == "cell" and src.domain == (33, 6)
    got = ops.execute(cp_t, {nid: torch.tensor(vals[n])
                             for nid, n in names_t.items()}, kernels="cuda")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.execute_dense(cp_r, env_r)),
                               rtol=TOL, atol=TOL)


def test_source_is_per_cplan_and_independent_of_m():
    case = next(c for c in sweep.cases() if c.name == "row/col_t_agg_mm4")
    a = cuda_src.source_for(sweep.fused_cplan(case, 33, 7)[0])
    b = cuda_src.source_for(sweep.fused_cplan(case, 999, 7)[0])
    c = cuda_src.source_for(sweep.fused_cplan(case, 33, 9)[0])
    assert a.text == b.text and a.key == b.key      # one build for every m
    assert a.text != c.text                          # widths are constants
    assert build.library_path(a) == build.library_path(b)
    assert '#include "row.cuh"' in a.text and "repro_launch" in a.text


def test_main_path_cplans_generate():
    """Every CPlan of the L2SVM iteration has a CUDA kernel, routed as the
    reference routes it (Row, MAgg, Cell for the single-root MAgg)."""
    X, w, y = (torch.empty(s, device="meta")
               for s in ((4096, 100), (100, 1), (4096, 1)))
    lam = torch.empty((1, 1), device="meta")
    ctx = FusionContext(device="cpu")
    planned = l2svm._objective_full.trace(X, w, y, lam).plan(context=ctx)
    got = []
    for pl in (l2svm._hinge.trace(X, w, y).plan(context=ctx),
               l2svm._search_terms.trace(y, y).plan(context=ctx),
               planned, planned.backward()):
        got += [cuda_src.source_for(cp).template
                for cp in compile_plan(pl.eplan).cplans()]
    assert got == ["row", "magg", "row", "cell", "row", "row", "cell",
                   "cell"]


def test_kernel_modules_import_without_nvcc_or_a_card():
    """The modules imported above; nothing compiles until a launch, and
    without the toolkit the build step says so instead of falling back."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    if shutil.which("nvcc") is None and CUDA_HOME is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.nvcc_path()
    else:
        assert build.nvcc_path().endswith("nvcc")


def test_asking_for_the_card_raises_without_one():
    X = np.ones((8, 3), np.float32)
    y = np.ones((8, 1), np.float32)
    if torch.cuda.is_available():
        w, objs = l2svm.run(X, y, max_iter=1, device="cuda")
        assert w.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        l2svm.run(X, y, max_iter=1)                  # default: the card
    with pytest.raises(RuntimeError, match="cuda"):
        with FusionContext(device="cuda"):
            l2svm._hinge(X, np.ones((3, 1), np.float32), y)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    sent to the plain version."""
    case = next(c for c in sweep.cases() if c.name == "cell/no_agg")
    cp, names = sweep.fused_cplan(case, 8, 3)
    env = {nid: torch.empty(cp.binds[i].shape, device="meta")
           for i, nid in enumerate(names)}
    with pytest.raises(ValueError, match="CUDA"):
        ops.execute(cp, env, kernels="cuda")


def test_sparse_operands_wait_for_the_sparse_slice():
    """BCSR is ported; a compressed (CLA) or any other non-tensor operand
    is refused with its ROADMAP item."""
    case = next(c for c in sweep.cases() if c.name == "cell/no_agg")
    cp, names = sweep.fused_cplan(case, 8, 3)
    env = {nid: object() for nid in names}
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        ops.execute(cp, env, kernels="cuda")


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in sweep.cases()])
def test_error_scale_bounds_the_rounding(case):
    """The size ``chip_smoke.py`` holds each kernel's rounding against has
    the output's shape, is at least the result's magnitude, and bounds the
    fp32 plain version's distance from the same computation in fp64."""
    from repro_torch.kernels import ref
    cp, names = sweep.fused_cplan(case, 33, 7)
    vals = _values(case, (33, 7))
    env = {nid: torch.tensor(vals[n]) for nid, n in names.items()}
    scale = chip_smoke().error_scale(cp, env)
    plain = ref.execute_dense(cp, env)
    exact = ref.execute_dense(cp, {k: v.double() for k, v in env.items()})
    assert tuple(scale.shape) == tuple(plain.shape)
    assert bool((scale >= plain.abs() * (1 - 1e-6)).all())
    eps = torch.finfo(torch.float32).eps
    assert bool(((plain.double() - exact).abs() <= 4 * eps * scale).all())


def test_planted_fault_is_only_in_its_own_builds():
    smoke = chip_smoke()
    case = next(c for c in sweep.cases() if c.name == "cell/full_agg_abs_sum")
    src = cuda_src.source_for(sweep.fused_cplan(case, 33, 7)[0])
    bad = smoke.planted(src)
    assert "RK_PLANTED_FAULT" not in src.text and src.elems > 0
    assert bad.text == smoke.PLANT + src.text and bad.key != src.key
    assert build.library_path(bad) != build.library_path(src)
    assert "#ifdef RK_PLANTED_FAULT" in (build.CSRC / "common.cuh").read_text()
    elementwise = next(c for c in sweep.cases() if c.name == "cell/no_agg")
    plain_src = cuda_src.source_for(sweep.fused_cplan(elementwise, 33, 7)[0])
    assert smoke.planted(plain_src) is plain_src
    # a Row row_agg has no partials: its fault drops a lane's row partial
    row_agg = next(c for c in sweep.cases() if c.name == "row/row_agg_sum")
    row_src = cuda_src.source_for(sweep.fused_cplan(row_agg, 33, 7)[0])
    assert row_src.elems == 0 and row_src.variant == "row_agg"
    assert smoke.planted(row_src).text == smoke.PLANT + row_src.text
    assert "#ifdef RK_PLANTED_FAULT" in (build.CSRC / "row.cuh").read_text()
    # the tile layout: a row_agg drops the middle element of each row, a
    # col_t_agg close the middle row slice of each CTA (rowtile::kPlanted)
    for name in ("row/row_agg_min_w5", "row/col_t_agg_hvp_mm5"):
        case = next(c for c in sweep.cases() if c.name == name)
        src = cuda_src.source_for(sweep.fused_cplan(case, 33, 7)[0])
        assert src.layout == "tile" and name in smoke.PLANTED
        bad = smoke.planted(src)
        assert bad.text == smoke.PLANT + src.text and bad.key != src.key
        assert "RK_PLANTED_FAULT" not in src.text
    assert "rowtile::kPlanted" in row_src.text and row_src.layout == "tile"
    assert "rowtile::kPlanted && q == P::SL / 2" in \
        (build.CSRC / "row.cuh").read_text()
