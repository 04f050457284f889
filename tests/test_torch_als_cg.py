"""ALS-CG on the port (``repro_torch.algos.als_cg``) against the JAX
reference's ``als_cg.run(mode="gen")``, on the CPU, on the reference's own
``ratings(384, 256, ...)`` matrix carried across with ``interop.to_bcsr``
and, separately, drawn by the port's ``data.ratings``.

Loss traces agree to 1e-5 relative: the plain versions repeat the
reference's arithmetic (per-block products, in-order block sums), and five
CG steps do not amplify the fp32 reordering beyond that at these sizes.
The port's gen path against its own dense-mask hand baseline is held to
the reference's 5e-2 (``tests/test_algos.py``): the two reach the same
factorisation through differently rounded CG iterates.
"""

import numpy as np
import pytest
import torch

from repro.algos import als_cg as ref_als
from repro.algos import data as ref_data
from repro_torch.algos import als_cg, data
from repro_torch.interop import to_bcsr
from repro_torch.kernels import outerprod

torch.set_num_threads(1)
KW = dict(rank=4, max_iter=2, max_inner=2)


@pytest.fixture(scope="module")
def reference():
    X = ref_data.ratings(384, 256, rank=4, bs=128, block_density=0.5, seed=6)
    U, V, losses = ref_als.run(X, mode="gen", **KW)
    return X, np.asarray(U), np.asarray(V), losses


@pytest.mark.parametrize("kernels", ["cuda", "never"])
def test_loss_trace_and_factors_match_reference(reference, kernels):
    X_ref, U_ref, V_ref, want = reference
    before = outerprod.launches
    U, V, got = als_cg.run(to_bcsr(X_ref, "cpu"), kernels=kernels,
                           device="cpu", **KW)
    assert outerprod.launches == before      # CPU: the plain versions
    assert len(got) == len(want) == KW["max_iter"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(U.numpy(), U_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(V.numpy(), V_ref, rtol=1e-4, atol=1e-5)


def test_port_ratings_give_the_reference_trace(reference):
    _X, _U, _V, want = reference
    X = data.ratings(384, 256, rank=4, bs=128, block_density=0.5, seed=6,
                     device="cpu")
    _U2, _V2, got = als_cg.run(X, device="cpu", **KW)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gen_matches_the_hand_baseline():
    X = data.ratings(512, 384, rank=6, bs=128, block_density=0.4, seed=4,
                     device="cpu")
    kw = dict(rank=6, max_iter=3, max_inner=3, device="cpu")
    _u, _v, gen = als_cg.run(X, **kw)
    _u, _v, hand = als_cg.run(X, mode="hand", **kw)
    np.testing.assert_allclose(gen, hand, rtol=5e-2)
    assert hand[-1] < hand[0] * 0.5                 # real progress


def test_run_defaults_to_the_card():
    X = data.ratings(256, 256, rank=2, bs=128, seed=1, device="cpu")
    if torch.cuda.is_available():
        _u, _v, losses = als_cg.run(X, rank=2, max_iter=1, max_inner=1)
        assert len(losses) == 1
        return
    with pytest.raises(RuntimeError, match="cuda"):
        als_cg.run(X, rank=2, max_iter=1, max_inner=1)
