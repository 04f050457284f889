"""Distributed segments on a real mesh: 8 gloo ranks on the CPU, as
subprocesses, against the reference on the same numpy inputs — the port's
counterpart of the reference's 8 forced host devices
(``tests/test_dist_exec.py``, ``tests/test_pallas_segments.py``).

One spawn of 8 ranks (``tests/torch_dist_worker.py``, importing only the
port, ``file://`` rendezvous in ``tmp_path``, ``OMP_NUM_THREADS=1``, a
60 s process-group timeout, a join deadline after which every rank is
killed) runs every check; each rank asserts what it can see (one segment
step of ≥ 2 members, no recorded fallback, collectives launched, the
strict raise) and writes its outputs, which the parent holds against the
reference's, computed in this process:

* the 6-operand segment program against the reference's local plan, 1e-5;
* ``l2svm.run`` / ``mlogreg.run(layout=mesh)``: traces at 1e-5 relative
  and parameters at 1e-4 against the reference's
  ``run(layout=LogicalMesh({"data": 8}))``;
* the hybrid gradient of the regularized NLL, 1e-5;
* the distributed Outer over a BCSR (2 block rows a rank), 1e-5;
* the strict program (12 block rows, not partitionable across 8): the
  default mode's answer at 1e-5 of max(|ref|, 1) — fp32 sums over a
  differently ordered product reach 1.5e-5 of the largest output, so the
  reference's absolute 1e-5 on outputs up to 505 is no bound for it
  (ROADMAP queue C);
* ``fuse_exprs`` of the segment program under the mesh against the
  reference's local plan, 1e-5;
* the fused loss under ``TrainConfig(fusion="gen", fusion_layout=mesh)``
  (64 x 256 logits, 8 rows a rank) and its gradient against the
  reference's local ``_ce``, 1e-5 (of the largest gradient);
* every rank's outputs equal rank 0's, bit for bit.

A second spawn has rank 3 raise before the first collective: the run must
fail at once, not hang until the process group times out.
"""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.algos import l2svm as ref_l2svm
from repro.algos import mlogreg as ref_mlogreg
from repro.core import Fused as RefFused
from repro.core import FusionContext as RefContext
from repro.core import fuse_exprs as ref_fuse_exprs
from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro.dist.planner import LogicalMesh as RefMesh
from repro.kernels.blocksparse import BCSR as RefBCSR
from repro.launch import train as ref_train
from repro_torch.dist.launch import RankFailure, rank_env, run_ranks

import torch_dist_worker as worker

WORLD = 8
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"


def _spawn(case: str, tmp: Path, timeout: float) -> list[str]:
    init = f"file://{tmp / 'rendezvous'}"
    return run_ranks(lambda r: [sys.executable, str(WORKER), case, str(r),
                                str(WORLD), init, str(tmp)],
                     WORLD, timeout=timeout, env=rank_env())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs (one spawn for the whole file)."""
    tmp = tmp_path_factory.mktemp("dist")
    _spawn("all", tmp, timeout=300)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def data():
    return worker.inputs()


def test_every_rank_returns_the_same_values(ranks):
    for r in range(1, WORLD):
        assert ranks[r].keys() == ranks[0].keys()
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k])
    assert int(ranks[0]["collectives"]) > 0


@pytest.mark.parametrize("run", ["seg", "seg_per_op", "seg_2d"])
def test_segment_program_matches_the_local_plan(ranks, data, run):
    """The staged segment step, the per-operator path (``staged=False``)
    and a 2-D mesh ({"data": 4, "model": 2}: the row group is half the
    ranks) each give the reference's local plan."""
    f = ref_fused(worker.segment_expr(ref_ir))
    want = f.trace(*data["seg"]).plan(mode="gen").compile()(*data["seg"])
    for i, w in enumerate(want):
        np.testing.assert_allclose(ranks[0][f"{run}{i}"], np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_l2svm_under_the_mesh_matches_the_reference(ranks, data):
    X, y = (jnp.asarray(a) for a in data["l2svm"])
    w, objs = ref_l2svm.run(X, y, max_iter=4, layout=RefMesh({"data": WORLD}))
    np.testing.assert_allclose(ranks[0]["l2svm_objs"], objs, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["l2svm_w"], np.asarray(w),
                               rtol=1e-4, atol=1e-4)


def test_mlogreg_under_the_mesh_matches_the_reference(ranks, data):
    X, Y = (jnp.asarray(a) for a in data["mlogreg"])
    B, nlls = ref_mlogreg.run(X, Y, max_outer=3, max_inner=5,
                              layout=RefMesh({"data": WORLD}))
    np.testing.assert_allclose(ranks[0]["mlogreg_nlls"], nlls, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["mlogreg_B"], np.asarray(B),
                               rtol=1e-4, atol=1e-4)


def test_hybrid_gradient_matches_the_reference(ranks, data):
    X, B, Y, lam = (jnp.asarray(a) for a in data["grad"])
    with RefContext(mode="gen", layout=RefMesh({"data": WORLD})):
        g = jax.grad(lambda B_: ref_mlogreg._nll_obj_reg(X, B_, Y, lam)
                     [0, 0])(B)
    np.testing.assert_allclose(ranks[0]["grad"], np.asarray(g), rtol=1e-5,
                               atol=1e-5)


def _ref_outer(case, data):
    dense, U, V = data[case]
    f = RefFused(worker.outer_expr(ref_ir), sparsity={"X": 0.05})
    X = RefBCSR.from_dense(dense, bs=128)
    got = f.trace(X=X, U=U, V=V).plan(mode="gen").compile()(X=X, U=U, V=V)
    return np.asarray(got)


def test_distributed_outer_over_bcsr_matches_the_reference(ranks, data):
    np.testing.assert_allclose(ranks[0]["outer"], _ref_outer("outer", data),
                               rtol=1e-5, atol=1e-5)


def test_strict_program_downgrades_with_its_reason_and_right_answer(
        ranks, data):
    """The rank asserted the recorded "not partitionable" reason and the
    strict raise; the default mode's answer is right."""
    want = _ref_outer("strict", data)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(ranks[0]["strict"], want, rtol=0,
                               atol=1e-5 * scale)


def test_fuse_exprs_under_the_mesh_matches_the_local_plan(ranks, data):
    """``fuse_exprs`` of the segment program's hand-built DAG, scoped
    under the mesh, gives the reference's local plan."""
    names = ["X1", "X2", "X3", "X4", "X5", "X6", "w"]
    leaves = {n: ref_ir.matrix(n, v.shape) for n, v in zip(names, data["seg"])}
    want = ref_fuse_exprs(worker.segment_expr(ref_ir)(**leaves),
                          dict(zip(names, data["seg"])))
    for i, w in enumerate(want):
        np.testing.assert_allclose(ranks[0][f"fuse_exprs{i}"], np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_fused_loss_under_the_mesh_matches_the_local_plan(ranks, data):
    """The loss under ``TrainConfig(fusion="gen", fusion_layout=mesh)`` —
    each rank's Row plan over its 8 rows, forward and planned backward —
    and its gradient give the reference's local plan's."""
    logits, targets = (jnp.asarray(a) for a in data["ce"])
    tc = ref_train.TrainConfig(fusion="gen")
    loss, g = jax.value_and_grad(
        lambda L: ref_train._ce(L, targets, tc))(logits)
    np.testing.assert_allclose(ranks[0]["ce_loss"], float(loss), rtol=1e-5)
    top = float(jnp.abs(g).max())
    np.testing.assert_allclose(ranks[0]["ce_grad"], np.asarray(g), rtol=0,
                               atol=1e-5 * top)


def test_a_failing_rank_fails_the_run_without_a_hang(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 3 fails before the "
                                          "collective"):
        _spawn("raise", tmp_path, timeout=120)
    assert time.monotonic() - t0 < 50      # the process group waits 60 s
