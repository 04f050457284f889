"""MLogReg, GLM, KMeans and the autoencoder end to end: each port's
``run(device="cpu", kernels="never")`` against the JAX reference's
``run(pallas="never")``, in the planner arms ``gen``, ``fa`` and ``none``
and the hand-written baseline ``hand``, on the same numpy data (both
packages' ``data`` generators draw the same values from the same seed).

Tolerances: 1e-5 relative on the objective / deviance / WCSS / loss
trace, 1e-4 relative with 1e-5 absolute on the returned parameters (as
``tests/test_torch_als_cg.py``).  The two packages sum in different
orders; the CG solves and SGD steps carry those differences from one
iteration to the next, but at these sizes they stay inside both."""

import numpy as np
import pytest
import torch

from repro.algos import autoencoder as ref_autoencoder
from repro.algos import data as ref_data
from repro.algos import glm as ref_glm
from repro.algos import kmeans as ref_kmeans
from repro.algos import mlogreg as ref_mlogreg
from repro_torch import algos
from repro_torch.algos import autoencoder, data, glm, kmeans, mlogreg
from repro_torch.interop import to_torch

torch.set_num_threads(1)
TRACE_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
MODES = ("gen", "fa", "none", "hand")


def _mlogreg_data():
    X, Y, _y = data.classification(400, 24, k=4, seed=2, device="cpu")
    return (X, Y), tuple(ref_data.classification(400, 24, k=4, seed=2)[:2])


def _glm_data():
    return (data.regression(300, 16, seed=2, device="cpu"),
            ref_data.regression(300, 16, seed=2))


def _kmeans_data():
    # C0 = the first k rows of X, as the reference's tests start
    X, _centers = data.clusters(300, 8, seed=2, device="cpu")
    rX, _rc = ref_data.clusters(300, 8, seed=2)
    return (X, X[:5].clone()), (rX, rX[:5])


def _autoencoder_data():
    return ((data.images(256, 64, seed=2, device="cpu"),),
            (ref_data.images(256, 64, seed=2),))


#: name -> (port module, reference module, data, run keywords, how to list
#: the parameters a run returns)
ALGOS = {
    "mlogreg": (mlogreg, ref_mlogreg, _mlogreg_data,
                dict(max_outer=3, max_inner=5), lambda out: [out]),
    "glm": (glm, ref_glm, _glm_data, dict(max_outer=3, max_inner=5),
            lambda out: [out]),
    "kmeans": (kmeans, ref_kmeans, _kmeans_data, dict(max_iter=5),
               lambda out: [out]),
    "autoencoder": (autoencoder, ref_autoencoder, _autoencoder_data,
                    dict(h1=16, h2=2, batch=32),
                    lambda out: list(out[0]) + list(out[1])),
}


@pytest.fixture(scope="module")
def problems():
    """name -> (port operands, reference operands), checked equal."""
    out = {}
    for name, (_p, _r, make, _kw, _params) in ALGOS.items():
        port, ref = make()
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        out[name] = (port, ref)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(ALGOS))
def test_run_matches_reference(problems, name, mode):
    port_mod, ref_mod, _make, kw, params = ALGOS[name]
    port_args, ref_args = problems[name]
    got_p, got = port_mod.run(*port_args, mode=mode, kernels="never",
                              device="cpu", **kw)
    want_p, want = ref_mod.run(*ref_args, mode=mode, pallas="never", **kw)
    assert len(got) == len(want) > 1
    np.testing.assert_allclose(got, want, rtol=TRACE_RTOL,
                               err_msg=f"{name} {mode} trace")
    for i, (a, b) in enumerate(zip(params(got_p), params(want_p))):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{name} {mode} parameter {i}")


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_run_defaults_to_the_card(problems, name):
    port_mod, _ref, _make, _kw, _params = ALGOS[name]
    port_args, _ref_args = problems[name]
    small = {"mlogreg": dict(max_outer=1, max_inner=1),
             "glm": dict(max_outer=1, max_inner=1),
             "kmeans": dict(max_iter=1),
             "autoencoder": dict(h1=4, batch=128, epochs=1)}[name]
    if torch.cuda.is_available():
        _out, trace = port_mod.run(*port_args, **small)
        assert len(trace) >= 1
        return
    with pytest.raises(RuntimeError, match="cuda"):
        port_mod.run(*port_args, **small)


def test_algos_lists_the_reference_suite():
    from repro.algos import ALGOS as REF_ALGOS
    assert list(algos.ALGOS) == list(REF_ALGOS)
    assert {k: m.__name__.rsplit(".", 1)[1] for k, m in algos.ALGOS.items()} \
        == {k: m.__name__.rsplit(".", 1)[1] for k, m in REF_ALGOS.items()}


def test_autoencoder_starts_from_the_reference_weights():
    """Both packages' seeded draws give equal starting weights; the
    reference's (Ws, bs) cross over with ``interop.to_torch``."""
    X = data.images(64, 32, seed=1, device="cpu")
    (Ws, bs), _ = autoencoder.run(X, h1=8, batch=64, lr=0.0, mu=0.0,
                                  kernels="never", device="cpu")
    (rWs, rbs), _ = ref_autoencoder.run(np.asarray(X), h1=8, batch=64,
                                        lr=0.0, mu=0.0)
    for a, b in zip(Ws + bs, to_torch([np.array(v) for v in rWs + rbs],
                                      "cpu")):
        assert torch.equal(a, b)


def test_kmeans_assigns_every_row():
    """Every row's assignment sums to 1 (the D == dmin comparison finds the
    fused operator's minimum) and C stays finite."""
    X, _c = data.clusters(500, 8, seed=5, device="cpu")
    C, wcss = kmeans.run(X, X[:5].clone(), max_iter=4, device="cpu")
    assert bool(torch.isfinite(C).all()) and all(np.isfinite(wcss))
    assert wcss[-1] <= wcss[0]
