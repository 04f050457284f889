"""The generated CUDA kernels on the card: each sweep case against its
plain version on the same CUDA tensors, bit-for-bit repeatability (no
float atomics), every L2SVM / mlogreg / kmeans region forward and planned
backward on the card against the CPU, and L2SVM on the card against the
CPU.  Marked ``gpu``; without a card every test skips.  Imports no JAX
(the machine with the card has none):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.algos import data, l2svm
from repro_torch.core import FusionContext
from repro_torch.core.codegen import compile_plan
from repro_torch.kernels import (build, cellwise, cuda_src, multiagg, ops,
                                 rowwise, sweep)

from torch_regions import GRADS, chip_smoke, inputs, regions, run_port

#: regions whose planned backward the tests run
GRADS_FNS = {fn for name, (fn, _s) in regions(1, 1).items() if name in GRADS}

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)
SWEEP_SHAPES = ((1031, 7), (100_003, 7))
REGION_SHAPE = (4099, 12, 3)


@pytest.fixture(scope="module")
def card():
    """The card, with every kernel these tests launch built up front, one
    nvcc per source in parallel (the tests' shapes share the sources)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cplans = [sweep.fused_cplan(c, *SWEEP_SHAPES[0])[0]
              for c in sweep.cases()]
    for fn, shapes in regions(*REGION_SHAPE).values():
        planned = fn.trace(**{k: torch.empty(s, device="meta")
                              for k, s in shapes.items()}).plan(
            context=FusionContext(device="cpu"))
        cplans += compile_plan(planned.eplan).cplans()
        if fn in GRADS_FNS:
            cplans += compile_plan(planned.backward().eplan).cplans()
    build.build_all({s.key: s for s in map(cuda_src.source_for, cplans)}
                    .values())
    return torch.device("cuda")


def _env(case, shape, names, device, seed=11):
    rng = np.random.default_rng(seed)
    vals = {k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in case.shapes(*shape).items()}
    return {nid: torch.tensor(vals[n], device=device)
            for nid, n in names.items()}


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in sweep.cases()])
def test_kernel_matches_plain(card, case):
    """``chip_smoke.py``'s limit: per element, 16 fp32 eps times a
    first-order bound of the plain computation's rounding."""
    cp, names = sweep.fused_cplan(case, *SWEEP_SHAPES[0])
    env = _env(case, SWEEP_SHAPES[0], names, card)
    got = ops.execute(cp, env, kernels="cuda")
    err, share = chip_smoke().measure(cp, env, got, case.name)
    assert share <= 1.0, f"max |kernel - plain| {err:.3e}, {share:.3g} x limit"


@pytest.mark.parametrize("name", ["cell/full_agg_sum", "magg/k2_sum_max",
                                  "row/col_t_agg_mm4"])
def test_reductions_repeat_bit_for_bit(card, name):
    case = next(c for c in sweep.cases() if c.name == name)
    cp, names = sweep.fused_cplan(case, *SWEEP_SHAPES[1])
    env = _env(case, SWEEP_SHAPES[1], names, card)
    a = ops.execute(cp, env, kernels="cuda")
    b = ops.execute(cp, env, kernels="cuda")
    assert torch.equal(a, b)


def test_l2svm_on_the_card_matches_the_cpu(card):
    X, _Y, y = data.classification(512, 32, seed=3, device="cpu")
    before = (cellwise.launches, multiagg.launches, rowwise.launches)
    w, objs = l2svm.run(X, y, max_iter=5, kernels="cuda", device="cuda")
    after = (cellwise.launches, multiagg.launches, rowwise.launches)
    w_cpu, objs_cpu = l2svm.run(X, y, max_iter=5, device="cpu")
    assert all(a > b for a, b in zip(after, before))
    np.testing.assert_allclose(objs, objs_cpu, rtol=1e-5)
    np.testing.assert_allclose(w.cpu().numpy(), w_cpu.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(regions(1, 1)))
def test_region_forward_and_gradient_on_the_card(card, name):
    """Tolerance 1e-4: the card's fused kernels sum in another order."""
    fn, shapes = regions(*REGION_SHAPE)[name]
    vals = inputs(shapes, seed=sum(map(ord, name)))
    grad_wrt = GRADS.get(name, ())
    got, got_g = run_port(fn, vals, grad_wrt, device="cuda")
    want, want_g = run_port(fn, vals, grad_wrt, device="cpu")
    for a, b in zip(got + tuple(got_g.values()),
                    want + tuple(want_g.values())):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
