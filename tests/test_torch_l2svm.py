"""L2SVM end to end: ``repro_torch.algos.l2svm.run`` against the JAX
reference's ``repro.algos.l2svm.run`` at 512×32 for 5 iterations, on the
same data (both packages' ``data.classification`` draw the same numpy
values from the same seed).

Tolerance: 1e-5 relative on the objective trace and on the final w — the
two packages sum in different orders, and the exact line search and the
conjugate-direction update carry those differences from one iteration to
the next, but at this size they stay well inside it."""

import numpy as np
import pytest
import torch

from repro.algos import data as ref_data
from repro.algos import l2svm as ref_l2svm
from repro_torch.algos import data, l2svm

torch.set_num_threads(1)
TOL = 1e-5
M, N, ITERS = 512, 32, 5


@pytest.fixture(scope="module")
def problem():
    X, Y, y = data.classification(M, N, seed=3, device="cpu")
    rX, rY, ry = ref_data.classification(M, N, seed=3)
    for a, b in ((X, rX), (Y, rY), (y, ry)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return X, y, rX, ry


@pytest.fixture(scope="module")
def reference(problem):
    _X, _y, rX, ry = problem
    return {mode: ref_l2svm.run(rX, ry, max_iter=ITERS, mode=mode)
            for mode in ("gen", "hand")}


@pytest.mark.parametrize("mode,kernels", [("gen", "cuda"), ("gen", "never"),
                                          ("hand", "cuda")])
def test_run_matches_reference(problem, reference, mode, kernels):
    X, y, _rX, _ry = problem
    w, objs = l2svm.run(X, y, max_iter=ITERS, mode=mode, kernels=kernels,
                        device="cpu")
    rw, robjs = reference[mode]
    assert len(objs) == len(robjs) == ITERS
    np.testing.assert_allclose(objs, robjs, rtol=TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=TOL,
                               atol=TOL)


def test_run_takes_numpy_and_returns_on_the_device(problem):
    X, y, _rX, _ry = problem
    w, objs = l2svm.run(X.numpy(), y.numpy(), max_iter=2, device="cpu")
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    assert tuple(w.shape) == (N, 1) and all(np.isfinite(objs))
    assert objs[1] < objs[0]
