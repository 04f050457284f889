"""The torch-eager oracle against the reference's jnp oracle: every op of
``_UNARY``, ``_BINARY`` and ``_AGG_FN`` one by one through ``eval_node``,
the structural ops, and ``execute_dense`` for every template variant, on
the same numpy inputs.  Tolerance: 1e-6 relative (and absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sweep

from torch_harness import reference_cplan

torch.set_num_threads(1)
TOL = 1e-6


def _vals(shape=(6, 5), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.flat[:4] = [0.5, -1.5, 2.5, 0.0]       # round-half-even, sign(0)
    return x


def _both(op, ins, attrs):
    want = np.asarray(jref.eval_node(op, [jnp.asarray(v) if isinstance(
        v, np.ndarray) else v for v in ins], attrs))
    got = tref.eval_node(op, [torch.tensor(v) if isinstance(
        v, np.ndarray) else v for v in ins], attrs).numpy()
    return got, want


def _check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_op_tables_cover_the_reference():
    assert set(tref._UNARY) == set(jref._UNARY)
    assert set(tref._BINARY) == set(jref._BINARY)
    assert set(tref._AGG_FN) == set(jref._AGG_FN)


@pytest.mark.parametrize("op", sorted(jref._UNARY))
def test_unary(op):
    x = _vals()
    if op in ("log", "sqrt", "log1p"):
        x = np.abs(x) + 0.1
    if op == "recip":
        x[x == 0] = 1.0
    _check(*_both(op, [x], {}))


@pytest.mark.parametrize("op", sorted(jref._BINARY))
def test_binary(op):
    a, b = _vals(seed=1), _vals(seed=2)
    b[0, :3] = a[0, :3]                       # ties for the comparisons
    if op == "pow":
        a = np.abs(a) + 0.1
    if op == "div":
        b[b == 0] = 1.0
    _check(*_both(op, [a, b], {}))
    # broadcast against a (m,1) column and a literal, as programs do
    _check(*_both(op, [a, b[:, :1]], {}))
    _check(*_both(op, [a, 0.5], {}))
    _check(*_both(op, [0.5, b], {}))


@pytest.mark.parametrize("axis", ["full", "row", "col"])
@pytest.mark.parametrize("op", sorted(jref._AGG_FN))
def test_aggregate(op, axis):
    _check(*_both(op, [_vals()], {"axis": axis}))


@pytest.mark.parametrize("op,attrs", [
    ("where", {}), ("plus_mult", {}), ("minus_mult", {}),
    ("matmul", {}), ("matmul", {"ta": True}), ("matmul", {"tb": True}),
    ("t", {}), ("idx", {"lo": 1, "hi": 4})])
def test_structural(op, attrs):
    a, b, c = _vals(seed=3), _vals(seed=4), _vals(seed=5)
    if op == "where":
        a[a < 0] = 0.0
        ins = [a, b, c]
    elif op in ("plus_mult", "minus_mult"):
        ins = [a, b, c]
    elif op == "matmul":
        ins = [a, b[:5, :3]] if not attrs else \
            ([a, b] if attrs.get("ta") else [a, c[:3, :]])
    else:
        ins = [a]
    _check(*_both(op, ins, attrs))


def _cases():
    for c in sweep.cases():
        yield pytest.param(c, id=c.name)


@pytest.mark.parametrize("case", _cases())
def test_execute_dense_every_variant(case):
    """execute_dense of the same expression, planned by each package."""
    cp_r, names_r = reference_cplan(case, 9, 6)
    cp_t, names_t = sweep.fused_cplan(case, 9, 6)
    assert (cp_t.ttype.name, cp_t.variant) == (cp_r.ttype.name, cp_r.variant)
    rng = np.random.default_rng(7)
    vals = {k: rng.normal(size=s).astype(np.float32)
            for k, s in case.shapes(9, 6).items()}
    want = jref.execute_dense(cp_r, {nid: jnp.asarray(vals[n])
                                     for nid, n in names_r.items()})
    got = tref.execute_dense(cp_t, {nid: torch.tensor(vals[n])
                                    for nid, n in names_t.items()})
    _check(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["right_mm", "left_mm", "full_agg"])
def test_execute_dense_outer_variants(variant):
    """The Outer variants run the oracle over a dense main."""
    import importlib

    def plan(pkg):
        mod = lambda n: importlib.import_module(f"{pkg}.core.{n}")
        ir = mod("ir")
        X = ir.matrix("X", (256, 192), sparsity=0.05)
        U, V = ir.matrix("U", (256, 4)), ir.matrix("V", (192, 4))
        W = ir.matrix("W", (256, 4))
        c = ir.neq0(X) * (U @ V.T)
        out = {"right_mm": c @ V, "left_mm": W.T @ c,
               "full_agg": c.sum()}[variant]
        g = ir.Graph.build([out])
        memo = mod("explore").explore(g)
        entry = next(e for e in memo.entries(g.outputs[0].nid)
                     if e.ttype == mod("templates").TType.OUTER
                     and e.can_root)
        spec = mod("cost")._build_spec(g, memo, g.outputs[0].nid, entry,
                                       set())
        cp = mod("cplan").build_cplan(g, spec)
        names = {n.nid: n.name for n in g.inputs()}
        return cp, {b.nid: names[b.nid] for b in cp.binds}

    cp_r, names_r = plan("repro")
    cp_t, names_t = plan("repro_torch")
    assert cp_t.variant == cp_r.variant == variant
    rng = np.random.default_rng(8)
    vals = {"X": (rng.random((256, 192)) < 0.05).astype(np.float32)
            * rng.normal(size=(256, 192)).astype(np.float32),
            "U": rng.normal(size=(256, 4)).astype(np.float32),
            "V": rng.normal(size=(192, 4)).astype(np.float32),
            "W": rng.normal(size=(256, 4)).astype(np.float32)}
    want = jref.execute_dense(cp_r, {nid: jnp.asarray(vals[n])
                                     for nid, n in names_r.items()})
    got = tref.execute_dense(cp_t, {nid: torch.tensor(vals[n])
                                    for nid, n in names_t.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
