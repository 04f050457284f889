"""The planned backward of only the inputs autograd asks a gradient of
(``Planned.backward(wrt)``), on the CPU at a tiny size.

L2SVM's and MLogReg's objectives with only their weights requiring a
gradient, as ``l2svm.run`` and ``mlogreg.run`` differentiate them: the
backward is one Row ``col_t_agg`` pass over X and a Cell, with no basic
matmul and no (m, n) value; the backward returns ``None`` for X, y / Y and
λ; the weights' gradient equals the every-input plan's and
``torch.autograd`` on the plain expression in float64 (1e-5); a second
call plans nothing; a mask of every input runs the every-input plan,
operator for operator; ``explain(include_backward=True)`` reports the
backward plans the calls used; a bare ``str`` as ``wrt`` is refused.
"""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import FusionContext, fused
from repro_torch.core.codegen import _is_fused, compile_plan

from torch_regions import inputs, regions

torch.set_num_threads(1)
M, N, K = 64, 12, 3
TOL = 1e-5


def _l2svm_plain(X, w, y, lam):
    out = torch.relu(1.0 - y * (X @ w))
    return 0.5 * (out ** 2).sum() + 0.5 * lam[0, 0] * (w ** 2).sum()


def _mlogreg_plain(X, B, Y, lam):
    P = torch.softmax(X @ B, dim=1)
    return -(Y * torch.log(P + 1e-30)).sum() + 0.5 * lam[0, 0] * (B ** 2).sum()


#: region name -> (the weights' name, the plain objective)
CASES = {"l2svm/objective_full": ("w", _l2svm_plain),
         "mlogreg/nll_obj_reg": ("B", _mlogreg_plain)}


def _setup(name):
    region, shapes = regions(M, N, k=K)[name]
    vals = inputs(shapes, seed=sum(map(ord, name)))
    compiled = region.trace(**vals).plan(
        context=FusionContext(device="cpu")).compile()
    return region, compiled, vals


def _call(compiled, vals, wrt):
    """The objective (1, 1) and the operands, those in ``wrt`` requiring a
    gradient."""
    args = {k: torch.tensor(v, requires_grad=k in wrt)
            for k, v in vals.items()}
    return compiled(**args), args


def _grads(compiled, vals, wrt):
    out, args = _call(compiled, vals, wrt)
    gs = torch.autograd.grad(out[0, 0], [args[n] for n in wrt])
    return dict(zip(wrt, gs))


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_only_backward_is_one_row_pass_over_x(name):
    weights, _plain = CASES[name]
    _region, compiled, vals = _setup(name)
    _grads(compiled, vals, (weights,))
    (cp,) = compiled._bwd_plans.values()
    assert [(c.ttype.name, c.variant) for c in cp.cplans()] == \
        [("ROW", "col_t_agg"), ("CELL", "no_agg")]
    row = cp.cplans()[0]
    assert row.main.shape == (M, N)
    assert all(c.out_shape != (M, N) for c in cp.cplans())
    graph = cp.plan.graph
    for spec in cp.plan.specs:
        if not _is_fused(spec):
            node = graph.by_id[spec.root]
            assert node.op != "matmul", node
            assert tuple(node.shape) != (M, N), node


@pytest.mark.parametrize("name", sorted(CASES))
def test_unrequested_gradients_are_none(name):
    """The backward returns ``None`` (no zeros of X's size) for every
    input that needs no gradient."""
    weights, _plain = CASES[name]
    _region, compiled, vals = _setup(name)
    out, _args = _call(compiled, vals, (weights,))
    got = out.grad_fn.apply(torch.ones((1, 1)))
    names = compiled.planned.traced.in_names
    assert len(got) == 1 + len(names) and got[0] is None
    for n, g in zip(names, got[1:]):
        if n == weights:
            assert tuple(g.shape) == vals[n].shape
        else:
            assert g is None, n


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_gradient_matches_every_input_plan_and_plain(name):
    weights, plain = CASES[name]
    _region, compiled, vals = _setup(name)
    got = _grads(compiled, vals, (weights,))[weights]
    # the every-input plan on the same operands
    every, grad_names, ct_names = compiled._get_bwd()
    binds = {k: torch.tensor(v) for k, v in vals.items()}
    binds.update({n: torch.ones((1, 1)) for n in ct_names})
    want = dict(zip(grad_names, every(binds)))[weights]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    # torch.autograd on the plain expression, in float64
    args = {k: torch.tensor(v, dtype=torch.float64,
                            requires_grad=k == weights)
            for k, v in vals.items()}
    (ref,) = torch.autograd.grad(plain(**args), args[weights])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_repeat_backward_plans_nothing_new(name):
    weights, _plain = CASES[name]
    _region, compiled, vals = _setup(name)
    _grads(compiled, vals, (weights,))
    first, held = compiled._bwd_plans[(weights,)], dict(compiled.planned._bwds)
    with spans.recording() as rec:
        _grads(compiled, vals, (weights,))
    assert not [s for s in rec.spans if s.name.startswith("fused.plan:")]
    assert any(s.name.startswith("fused.backward:") for s in rec.spans)
    assert compiled._bwd_plans[(weights,)] is first
    assert list(compiled._bwd_plans) == [(weights,)]
    assert compiled.planned._bwds == held


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_input_mask_runs_the_every_input_plan(name):
    region, compiled, vals = _setup(name)
    names = tuple(vals)
    _grads(compiled, vals, names)
    (used,) = compiled._bwd_plans.values()
    assert used is compiled._get_bwd()[0]
    fresh = region.trace(**vals).plan(
        context=FusionContext(device="cpu")).backward()
    assert compiled.planned.backward(names).grad_names == fresh.grad_names
    assert [type(s).__name__ for s in used.plan.specs] == \
        [type(s).__name__ for s in fresh.eplan.specs]
    assert compiled.planned.backward(names).fused_signatures() == \
        fresh.fused_signatures()
    assert used.plan.cost == fresh.cost


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_reports_the_backward_plans_used(name):
    weights, _plain = CASES[name]
    _region, compiled, vals = _setup(name)
    rep = compiled.explain(include_backward=True)["backward"]
    assert rep["n_plans"] == 0 and rep["plans"] == []
    _grads(compiled, vals, (weights,))
    _grads(compiled, vals, tuple(vals))
    rep = compiled.explain(include_backward=True)
    back = rep["backward"]
    every = compiled.planned.wrt_key()
    # the every-input backward's report stays as Planned.explain gives it
    assert back["operators"] == \
        compiled.planned.backward().fused_signatures()
    assert back["n_plans"] == 2
    masked, full = back["plans"]
    assert masked["wrt"] == [weights]
    assert sorted(masked["skipped"]) == sorted(set(every) - {weights})
    assert masked["n_operators"] < full["n_operators"]
    assert masked["cost"] < full["cost"]
    assert full["wrt"] == list(every) and full["skipped"] == []
    assert full["operators"] == back["operators"]
    assert rep["execution"]["fallbacks"] == []


def test_an_input_with_no_path_keeps_an_exact_zero():
    """An input that needs a gradient but reaches the output only through
    a comparison gets zeros of its shape; one that needs none, ``None``."""
    f = fused(lambda a, b, c: (a * (b > 0.0)).sum() + (c * c).sum())
    rng = np.random.default_rng(0)
    a, b, c = (torch.tensor(rng.normal(size=(7, 3)).astype(np.float32),
                            requires_grad=r) for r in (True, True, False))
    with FusionContext(device="cpu"):
        out = f(a, b, c)
    ga, gb = torch.autograd.grad(out[0, 0], [a, b], retain_graph=True)
    np.testing.assert_allclose(ga.numpy(), (b > 0).float().numpy())
    assert torch.equal(gb, torch.zeros_like(b))
    assert out.grad_fn.apply(torch.ones((1, 1)))[3] is None
    (compiled,) = f._staged.values()
    assert list(compiled._bwd_plans) == [("a", "b")]


def test_backward_of_no_plan_input_raises():
    region, shapes = regions(M, N, k=K)["l2svm/objective_full"]
    planned = region.trace(**inputs(shapes)).plan(
        context=FusionContext(device="cpu"))
    with pytest.raises(ValueError, match="no input"):
        planned.backward(["nope"])


@pytest.mark.parametrize("wrt", ["w", "Xw"])
def test_backward_of_a_bare_str_raises(wrt):
    """A bare name is refused, not read as a set of one-letter names."""
    region, shapes = regions(M, N, k=K)["l2svm/objective_full"]
    planned = region.trace(**inputs(shapes)).plan(
        context=FusionContext(device="cpu"))
    with pytest.raises(TypeError, match="not the str"):
        planned.backward(wrt)
    with pytest.raises(TypeError, match="not the str"):
        planned.wrt_key(wrt)
    assert planned._bwds == {}


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_only_backward_sources_parse(name, tmp_path):
    """At the benchmark's 10⁷ × 100 the weights-only backward's Row takes
    the tile layout, and its Row and Cell sources parse against the CUDA
    stub."""
    from repro_torch.kernels import cuda_src
    from test_torch_cell_layout import _parse
    weights, _plain = CASES[name]
    region, shapes = regions(10_000_000, 100, k=5)[name]
    planned = region.trace(**{k: torch.empty(s, device="meta")
                              for k, s in shapes.items()}).plan(
        context=FusionContext(device="cpu"))
    cps = compile_plan(planned.backward([weights]).eplan).cplans()
    srcs = [cuda_src.source_for(cp) for cp in cps]
    assert [s.template for s in srcs] == ["row", "cell"]
    assert srcs[0].layout == "tile"
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{key}:\n{err}"
